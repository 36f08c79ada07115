"""The port's HBM record-cache tier and device record cache, on the
``torch`` engine on the CPU, and against the JAX package.

The rest of tests/test_hbm.py (tests/test_torch_distance.py holds the slot
gathers): a record served from a slot is byte-identical to the on-disk
form; admission stages genuine installs only and a full tier promotes only
proven-hot records; ``peek_split`` counts nothing and skips LOCKED slots;
tier off is inert and tier on moves bytes, not decisions; ``evaluate`` and
``ServingPlane.run`` report per-run deltas, and the plane's per-tenant tier
split sums to its total (with the reference plane's numbers); a static
partition gets no tier.  Then tests/test_velo_device.py's cache tests: admit,
touch and evict, second chance, sweeps, and the staged scatter whose device
mirror stays bit-identical to the host slot arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import dataset as ref_dataset
from repro.core import serving as ref_serving
from repro.core import vamana as ref_vamana
from repro.core import workload as ref_workload
from repro.core.quant import RabitQuantizer as RefQuantizer
from repro_torch import convert
from repro_torch.core import baselines
from repro_torch.core import distance as distance_mod
from repro_torch.core import workload as workload_mod
from repro_torch.core.bufferpool import RecordBufferPool
from repro_torch.core.hbm import HbmTier
from repro_torch.core.search import SearchParams
from repro_torch.core.serving import ServingPlane, TenantSpec, evaluate_plane
from repro_torch.core.sim import CostModel
from repro_torch.core.store import DecodedRecord
from repro_torch.velo.device_cache import FREE, LOCKED, MARKED, OCCUPIED, DeviceRecordCache


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    old = distance_mod.default_device()
    distance_mod.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    distance_mod.set_default_device(old)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def carried(small_qb, small_graph):
    return convert.index_from_reference(_fields(small_qb), _fields(small_graph))


def _record(qb, v, n):
    return DecodedRecord(vid=v, adjacency=np.asarray([(v + 1) % n, (v + 3) % n]),
                         ext_payload=qb.record_payload(v))


def _tier_with(qb, vids, n_slots=16):
    n = len(qb.ext_codes)
    tier = HbmTier(qb, np.arange(n) // 4, n_slots=n_slots, R=4)
    for v in vids:
        assert tier._stage(int(v), _record(qb, int(v), n))
    assert tier.scatter_staged() == len(vids)
    return tier


# ---------------------------------------------------------------- the tier


def test_lookup_roundtrip_bit_identity(carried):
    qb = carried[0]
    n = len(qb.ext_codes)
    tier = _tier_with(qb, [3, 7, 11])
    for v in (3, 7, 11):
        rec = tier.lookup(v)
        assert rec is not None and rec.vid == v
        assert rec.ext_payload == qb.record_payload(v)
        np.testing.assert_array_equal(rec.adjacency, np.asarray([(v + 1) % n, (v + 3) % n]))
    assert tier.lookup(5) is None
    assert tier.counters()["hits"] == 3 and tier.counters()["misses"] == 1


def test_peek_split_noncounting_and_locked(carried):
    tier = _tier_with(carried[0], np.asarray([4, 8, 12]))
    c0 = tier.counters()
    ids = np.asarray([4, 6, 8, 12], dtype=np.int64)
    mask, _ = tier.peek_split(ids)
    np.testing.assert_array_equal(mask, [True, False, True, True])
    assert tier.counters() == c0, "peek_split must not count hits/misses"
    tier.cache.slot_state[tier.cache.record_map[8]] = LOCKED  # mid-scatter
    mask2, slots2 = tier.peek_split(ids)
    np.testing.assert_array_equal(mask2, [True, False, False, True])
    assert len(slots2) == 2
    assert tier.peek_split(np.asarray([6], dtype=np.int64)) is None


def test_on_publish_fires_on_genuine_installs_only(carried):
    qb = carried[0]
    n = len(qb.ext_codes)
    seen = []
    pool = RecordBufferPool(8, np.arange(n) // 4, on_publish=lambda v, r: seen.append(v))
    pool.admit(1, _record(qb, 1, n))
    pool.admit(1, _record(qb, 1, n))  # duplicate: keep-first, no hook
    assert seen == [1]
    assert pool.begin_load(2) >= 0
    pool.finish_load(2, _record(qb, 2, n))
    assert seen == [1, 2]


def test_note_hit_promotion_threshold(carried):
    qb = carried[0]
    n = len(qb.ext_codes)
    tier = _tier_with(qb, list(range(8)), n_slots=8)  # full
    cold = _record(qb, 20, n)
    for _ in range(tier.promote_after - 1):
        tier.note_hit(20, cold)
        assert not tier._staged, "a not-yet-proven record must not stage"
    tier.note_hit(20, cold)
    assert [s[0] for s in tier._staged] == [20]
    tier.scatter_staged()
    tier.note_publish(30, _record(qb, 30, n))  # cold-tail publications never evict
    assert not tier._staged


# ------------------------------------------------------------ engine parity


def _small_system(ds, carried, hbm, **kw):
    qb, graph = carried
    cfg = baselines.SystemConfig(buffer_ratio=0.15, device="cpu", hbm_tier=hbm, **kw)
    return baselines.build_system("velo", ds.base, graph, qb, cfg)


def test_tier_off_builds_nothing(small_ds, carried):
    sys_ = _small_system(small_ds, carried, hbm=False)
    assert sys_.hbm is None and sys_.ctx.accessor.hbm is None
    assert sys_.ctx.accessor.pool.on_publish is None
    res = baselines.evaluate(sys_, small_ds)
    assert res["hbm_tier"] is False
    assert res["hbm_hits"] == res["hbm_scatters"] == res["hbm_evictions"] == 0
    assert res["combined_hit_rate"] == res["hit_rate"]


def test_tier_on_search_parity_deterministic(small_ds, carried):
    params = SearchParams(L=32, W=4, cbs=False, prefetch=False)
    off = _small_system(small_ds, carried, hbm=False, batch_size=1, params=params)
    on = _small_system(small_ds, carried, hbm=True, batch_size=1, params=params)
    res_off, _ = off.run(small_ds.queries)
    res_on, st_on = on.run(small_ds.queries)
    for i, (a, b) in enumerate(zip(res_off, res_on)):
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"q{i} ids")
        assert a.hops == b.hops, f"q{i} hops"
    assert st_on.hbm_hits > 0


def test_engine_tier_counters_and_uploads(small_ds, carried):
    sys_ = _small_system(small_ds, carried, hbm=True)
    res = baselines.evaluate(sys_, small_ds)
    assert res["hbm_tier"] is True and res["hbm_hits"] > 0 and res["hbm_scatters"] > 0
    assert res["dist_uploads"] <= 2
    assert sys_.ctx.dist.stats.slot_gathers > 0
    assert res["combined_hit_rate"] >= res["hit_rate"]
    assert res["memory_bytes"] > sys_.index.resident_bytes()


def test_evaluate_reports_per_run_deltas(small_ds, carried):
    sys_ = _small_system(small_ds, carried, hbm=True)
    baselines.evaluate(sys_, small_ds)
    c1 = sys_.hbm.counters()
    assert c1["hits"] > 0
    res2 = baselines.evaluate(sys_, small_ds)
    c2 = sys_.hbm.counters()
    for key in ("hits", "misses", "scatters", "evictions"):
        assert res2[f"hbm_{key}"] == c2[key] - c1[key], key
    assert res2["hbm_hits"] < c2["hits"], "delta, not the cumulative total"


def test_fused_batch_s_kind_routing():
    cost = CostModel(batch_dispatch_s=1e-6, full_dispatch_s=9e-6)
    assert cost.fused_batch_s(2e-6, kind="full") == pytest.approx(11e-6)
    assert cost.fused_batch_s(2e-6, kind="quant") == pytest.approx(3e-6)
    assert cost.fused_batch_s(2e-6) == pytest.approx(3e-6)
    assert CostModel().full_dispatch_s == CostModel().batch_dispatch_s


def test_apply_calibration_consumes_the_torch_entry():
    calib = {"torch": {"full_dispatch_s": 7e-6, "hbm_scatter_s": 2e-6, "not_a_field": 1.0},
             "batch": {"full_dispatch_s": 1.0}}
    cost = baselines.apply_calibration(CostModel(), "torch", calib)
    assert cost.full_dispatch_s == pytest.approx(7e-6)
    assert cost.hbm_scatter_s == pytest.approx(2e-6)


# -------------------------------------------------------------- serving plane


@pytest.fixture(scope="module")
def hbm_tenants():
    """(port specs, reference specs): tests/test_hbm.py's two tenants."""
    out, ref = [], []
    for i, n in enumerate((700, 600)):
        ds = ref_dataset.make_dataset(n=n, d=32, n_queries=30, k=10, seed=i)
        graph = ref_vamana.build_vamana(ds.base, R=12, L=24, batch_size=256, seed=i)
        qb = RefQuantizer(32, seed=i).fit_encode(ds.base)
        pqb, pgraph = convert.index_from_reference(_fields(qb), _fields(graph))
        out.append(TenantSpec.from_dataset(f"t{i}", ds, pgraph, pqb, system="velo"))
        ref.append(ref_serving.TenantSpec.from_dataset(f"t{i}", ds, graph, qb, system="velo"))
    return out, ref


def test_serving_plane_tier_split(hbm_tenants):
    specs, ref_specs = hbm_tenants
    plane = ServingPlane(specs, baselines.SystemConfig(buffer_ratio=0.15, hbm_tier=True,
                                                       device="cpu"))
    assert plane.hbm is not None
    out = evaluate_plane(plane, workload_mod.zipfian_mix([30, 30], n_ops=60, seed=0))
    assert out["hbm_tier"] is True and out["hbm_hits"] > 0
    assert sum(t["hbm_hits"] for t in out["tenants"].values()) == out["hbm_hits"]
    ref_plane = ref_serving.ServingPlane(ref_specs, ref_baselines.SystemConfig(
        buffer_ratio=0.15, hbm_tier=True, distance_backend="batch"))
    want = ref_serving.evaluate_plane(ref_plane,
                                      ref_workload.zipfian_mix([30, 30], n_ops=60, seed=0))
    for key in ("hbm_hits", "hbm_scatters", "hit_rate", "ios_per_query"):
        assert out[key] == want[key], key
    assert {k: v["hbm_hits"] for k, v in out["tenants"].items()} == {
        k: v["hbm_hits"] for k, v in want["tenants"].items()}
    # per-run delta idempotence on the plane
    c1 = plane.hbm.counters()
    out2 = evaluate_plane(plane, workload_mod.zipfian_mix([30, 30], n_ops=60, seed=0))
    c2 = plane.hbm.counters()
    assert out2["hbm_hits"] == c2["hits"] - c1["hits"]
    assert sum(t["hbm_hits"] for t in out2["tenants"].values()) == out2["hbm_hits"]


def test_serving_static_partition_gets_no_tier(hbm_tenants):
    plane = ServingPlane(hbm_tenants[0], baselines.SystemConfig(
        buffer_ratio=0.15, hbm_tier=True, device="cpu"), shared_pool=False)
    assert plane.hbm is None
    out = evaluate_plane(plane, workload_mod.uniform_mix([30, 30], n_ops=40, seed=1))
    assert out["hbm_tier"] is False and out["hbm_hits"] == 0


# ------------------------------------------------------- device record cache


def test_device_cache_admit_touch_evict():
    vid_to_page = np.arange(64) // 4
    c = DeviceRecordCache.create(8, vid_to_page, dim=16, R=4)
    vids = np.asarray([1, 2, 3])
    assert not c.resident_mask(vids).any()
    c.admit(vids, exts=np.zeros((3, 8), np.uint8), los=np.zeros(3), steps_=np.ones(3),
            adjs=[np.asarray([4, 5]), np.asarray([6]), np.asarray([7, 8, 9])],
            disk_pages=vid_to_page[vids])
    assert c.resident_mask(vids).all()
    c.touch(vids)
    assert c.hits == 3
    more = np.arange(10, 20)
    c.admit(more, np.zeros((10, 8), np.uint8), np.zeros(10), np.ones(10),
            [np.asarray([0])] * 10, vid_to_page[more])
    assert (c.slot_state != FREE).sum() == 8 and c.evictions > 0
    for v in [v for v in range(64) if c.record_map[v] < 0]:
        assert -(c.record_map[v] + 1) == vid_to_page[v]


def test_device_cache_second_chance():
    vid_to_page = np.arange(16)
    c = DeviceRecordCache.create(2, vid_to_page, dim=8, R=2)
    c.admit(np.asarray([0, 1]), np.zeros((2, 4), np.uint8), np.zeros(2), np.ones(2),
            [np.asarray([1]), np.asarray([0])], vid_to_page[:2])
    c.slot_state[:] = MARKED
    c.touch(np.asarray([0]))
    assert c.slot_state[c.record_map[0]] == OCCUPIED
    c.admit(np.asarray([5]), np.zeros((1, 4), np.uint8), np.zeros(1), np.ones(1),
            [np.asarray([0])], vid_to_page[5:6])
    assert c.resident_mask(np.asarray([0]))[0], "hot record must survive"
    assert not c.resident_mask(np.asarray([1]))[0]


def _filled_cache(n_slots=4, n=32):
    vid_to_page = np.arange(n) // 4
    c = DeviceRecordCache.create(n_slots, vid_to_page, dim=16, R=4)
    vids = np.arange(n_slots)
    c.admit(vids, np.full((n_slots, 8), 7, np.uint8), np.zeros(n_slots), np.ones(n_slots),
            [np.asarray([0])] * n_slots, vid_to_page[vids])
    return c, vid_to_page


def test_device_cache_sweep_all_locked():
    c, _ = _filled_cache()
    c.slot_state[:] = LOCKED
    before_map, before_vid = c.record_map.copy(), c.slot_vid.copy()
    assert len(c.sweep(3)) == 0
    assert (c.slot_state == LOCKED).all() and c.evictions == 0
    np.testing.assert_array_equal(c.record_map, before_map)
    np.testing.assert_array_equal(c.slot_vid, before_vid)


def test_device_cache_sweep_need_exceeds_slots():
    c, _ = _filled_cache(n_slots=4)
    assert len(c.sweep(100)) == 4
    assert (c.slot_state == FREE).all() and c.evictions == 4
    assert all(c.record_map[v] < 0 for v in range(4))


def test_device_cache_admit_already_resident():
    c, vid_to_page = _filled_cache(n_slots=4)
    slot0 = int(c.record_map[0])
    before_ext = c.cache_ext[slot0].copy()
    used_before = int((c.slot_state != FREE).sum())
    c.admit(np.asarray([0]), np.full((1, 8), 99, np.uint8), np.full(1, 5.0), np.full(1, 5.0),
            [np.asarray([1, 2])], vid_to_page[:1])
    assert int(c.record_map[0]) == slot0
    np.testing.assert_array_equal(c.cache_ext[slot0], before_ext)
    assert int((c.slot_state != FREE).sum()) == used_before


def test_hbm_scatter_double_buffer_parity(carried):
    """The staged scatter lands in the state a sequential per-record admit
    reaches, and its in-place device mirror stays bit-identical to the host
    slot arrays."""
    qb = carried[0]
    n = len(qb.ext_codes)
    vid_to_page = np.arange(n) // 4
    tier = HbmTier(qb, vid_to_page, n_slots=8, R=4)
    ref = DeviceRecordCache.create(8, vid_to_page, dim=qb.dim, R=4,
                                   code_cols=qb.ext_codes.shape[1])
    dev = torch.device("cpu")
    tier.device_arrays(dev)  # force the mirror so every scatter updates it
    ncode = qb.ext_codes.shape[1]
    rng = np.random.default_rng(0)
    for _ in range(6):
        staged = [int(v) for v in rng.choice(n, size=3, replace=False)
                  if tier._stage(int(v), _record(qb, int(v), n))]
        assert tier.scatter_staged() == len(staged)
        if staged:
            recs = [_record(qb, v, n) for v in staged]
            ref.admit(np.asarray(staged),
                      np.stack([np.frombuffer(r.ext_payload[:ncode], np.uint8) for r in recs]),
                      np.asarray([np.frombuffer(r.ext_payload[ncode:ncode + 4], np.float32)[0]
                                  for r in recs]),
                      np.asarray([np.frombuffer(r.ext_payload[ncode + 4:ncode + 8],
                                                np.float32)[0] for r in recs]),
                      [r.adjacency.astype(np.int32) for r in recs], vid_to_page[staged])
        for f in ("record_map", "slot_state", "slot_vid", "cache_ext"):
            np.testing.assert_array_equal(getattr(tier.cache, f), getattr(ref, f))
        ext_d, lo_d, step_d = tier.device_arrays(dev)
        np.testing.assert_array_equal(ext_d.numpy(), tier.cache.cache_ext)
        np.testing.assert_array_equal(lo_d.numpy(), tier.cache.cache_lo)
        np.testing.assert_array_equal(step_d.numpy(), tier.cache.cache_step)
