"""The port's multi-tenant serving plane, on its own and against the JAX
package's.

Contracts, on the ``torch`` distance engine on the CPU (the kernels' plain
versions) over one combined table:

  * Isolation: a one-tenant plane is the isolated system bit for bit (ids,
    dists, hops, reads, cache stats) for all five algorithms at B in
    {1, 8}; a two-tenant statically partitioned plane at B = 1 equals two
    isolated systems.
  * Against the reference: the port's plane returns the reference plane's
    ids, hops and reads with dists within tests/test_torch_system.py's bar
    (rtol 2e-3, atol 2e-3), and ``evaluate_plane`` reports its metrics.
  * The reference's own plane tests, on the port: combined tables, cross
    tenant fusion with one upload, soft quotas, per-run deltas, the
    per-tenant latency split under EDF reordering, sharing under skew.
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
from repro_torch.core.search import ALGORITHMS, SearchParams
from repro_torch.core.serving import ServingPlane, TenantSpec, combined_table, evaluate_plane

ALGOS = sorted(ALGORITHMS)
# stride prefetch is the one schedule-sensitive piece: the parity params
# turn it off (as tests/test_serving.py does)
PARITY_PARAMS = SearchParams(L=32, W=4, prefetch=False)
DIST_TOL = dict(rtol=2e-3, atol=2e-3)


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
def tenant_data():
    """Two tenants (700 and 600 vectors, d = 32), built once by the
    reference and carried into the port: (ds, ref graph, ref qb, graph, qb)."""
    out = []
    for i, n in enumerate((700, 600)):
        ds = ref_dataset.make_dataset(n=n, d=32, n_queries=30, k=10, seed=i)
        graph = ref_vamana.build_vamana(ds.base, R=12, L=24, batch_size=256, seed=i)
        qb = RefQuantizer(32, seed=i).fit_encode(ds.base)
        port_qb, port_graph = convert.index_from_reference(_fields(qb), _fields(graph))
        out.append((ds, graph, qb, port_graph, port_qb))
    return out


def _spec(tenant_data, i, algo, params=PARITY_PARAMS, name=None, ref=False):
    ds, rgraph, rqb, graph, qb = tenant_data[i]
    cls = ref_serving.TenantSpec if ref else TenantSpec
    return cls.from_dataset(name or f"t{i}", ds, rgraph if ref else graph,
                            rqb if ref else qb, system=algo, params=params)


def _cfg(mod=baselines, **kw):
    if mod is baselines:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("distance_backend", "batch")
    return mod.SystemConfig(**kw)


def _isolated(tenant_data, i, algo, batch_size, n_queries, params=PARITY_PARAMS):
    ds, _, _, graph, qb = tenant_data[i]
    cfg = _cfg(buffer_ratio=0.2, batch_size=batch_size, params=params)
    return baselines.build_system(algo, ds.base, graph, qb, cfg).run(ds.queries[:n_queries])


def _assert_bitwise(ref, got, label):
    assert len(ref) == len(got)
    for i, (r0, r1) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(r0.ids, r1.ids, err_msg=f"{label} q{i}: ids")
        np.testing.assert_array_equal(r0.dists, r1.dists, err_msg=f"{label} q{i}: dists")
        assert r0.hops == r1.hops, f"{label} q{i}: hops"
        assert r0.reads == r1.reads, f"{label} q{i}: reads"


def _assert_matches_reference(want, got, label):
    assert len(want) == len(got)
    for i, (r0, r1) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(r0.ids, r1.ids, err_msg=f"{label} q{i}: ids")
        assert r0.hops == r1.hops, f"{label} q{i}: hops"
        assert r0.reads == r1.reads, f"{label} q{i}: reads"
        np.testing.assert_allclose(r0.dists, r1.dists, **DIST_TOL, err_msg=f"{label} q{i}")


# ------------------------------------------------------- isolation contract


@pytest.mark.parametrize("batch_size", [1, 8])
@pytest.mark.parametrize("algo", ALGOS)
def test_single_tenant_plane_bitwise_equals_isolated(algo, batch_size, tenant_data):
    plane = ServingPlane([_spec(tenant_data, 0, algo)],
                         _cfg(buffer_ratio=0.2, batch_size=batch_size, params=PARITY_PARAMS),
                         shared_pool=True)
    assert plane.dist.name == "torch" and plane.dist.device == torch.device("cpu")
    run = plane.run(workload_mod.uniform_mix([30], 30, seed=0))
    ref, ref_stats = _isolated(tenant_data, 0, algo, batch_size, 30)
    _assert_bitwise(ref, run.tenants[0].results, f"{algo} B={batch_size}")
    ts = run.tenants[0].stats
    assert (ts.cache_hits, ts.cache_misses) == (ref_stats.cache_hits, ref_stats.cache_misses)


@pytest.mark.parametrize("algo", ALGOS)
def test_two_tenant_partitioned_plane_bitwise_equals_isolated(algo, tenant_data):
    specs = [_spec(tenant_data, 0, algo, name="a"), _spec(tenant_data, 1, algo, name="b")]
    plane = ServingPlane(specs, _cfg(buffer_ratio=0.2, batch_size=1, params=PARITY_PARAMS),
                         shared_pool=False)
    run = plane.run(workload_mod.uniform_mix([30, 30], 40, seed=3))
    assert plane.pool is None  # static partition: no shared pool instance
    for tid in (0, 1):
        tr = run.tenants[tid]
        ref, ref_stats = _isolated(tenant_data, tid, algo, 1, tr.stats.n_queries)
        _assert_bitwise(ref, tr.results, f"{algo} tenant{tid}")
        assert (tr.stats.cache_hits, tr.stats.cache_misses) == (
            ref_stats.cache_hits, ref_stats.cache_misses)


# --------------------------------------------------------- the reference plane


@pytest.mark.parametrize("algo,shared,workers", [
    ("velo", True, 2), ("velo", False, 1), ("diskann", True, 1), ("starling", True, 2),
])
def test_plane_matches_reference_plane(algo, shared, workers, tenant_data):
    params = SearchParams(L=32, W=4)
    kw = dict(buffer_ratio=0.15, n_workers=workers, batch_size=4, fuse=True, params=params)
    wl = dict(counts=[30, 30], n_ops=60, s=1.4, seed=1)
    want = ref_serving.ServingPlane(
        [_spec(tenant_data, i, algo, params, ref=True) for i in (0, 1)],
        _cfg(ref_baselines, **kw), shared_pool=shared,
    ).run(ref_workload.zipfian_mix(wl["counts"], wl["n_ops"], s=wl["s"], seed=wl["seed"]))
    plane = ServingPlane([_spec(tenant_data, i, algo, params) for i in (0, 1)], _cfg(**kw),
                         shared_pool=shared)
    got = plane.run(workload_mod.zipfian_mix(wl["counts"], wl["n_ops"], s=wl["s"],
                                             seed=wl["seed"]))
    _assert_matches_reference(want.results, got.results, f"{algo} shared={shared}")
    for a, b in zip(want.tenants, got.tenants):
        assert (a.name, a.recall, a.stats.n_queries) == (b.name, b.recall, b.stats.n_queries)
        assert (a.stats.cache_hits, a.stats.cache_misses, a.stats.io_count) == (
            b.stats.cache_hits, b.stats.cache_misses, b.stats.io_count)
    assert got.stats.makespan_s == pytest.approx(want.stats.makespan_s, rel=1e-9)
    assert plane.dist.stats.uploads == 1


def test_evaluate_plane_matches_reference(tenant_data):
    """The serving-side metric dict, HBM tier on, a zipfian mix: every
    number the reference reports, the port reports."""
    kw = dict(buffer_ratio=0.15, hbm_tier=True, batch_size=4, fuse=True)
    want = ref_serving.evaluate_plane(
        ref_serving.ServingPlane([_spec(tenant_data, i, "velo", None, ref=True) for i in (0, 1)],
                                 _cfg(ref_baselines, **kw)),
        ref_workload.zipfian_mix([30, 30], n_ops=60, seed=0))
    plane = ServingPlane([_spec(tenant_data, i, "velo", None) for i in (0, 1)], _cfg(**kw))
    got = evaluate_plane(plane, workload_mod.zipfian_mix([30, 30], n_ops=60, seed=0))
    assert got.pop("distance_backend") == "torch" and want.pop("distance_backend") == "batch"
    assert got["hbm_tier"] is True and got["hbm_hits"] > 0
    _assert_same_metrics(got, want)


def _assert_same_metrics(got: dict, want: dict, path: str = "") -> None:
    assert set(got) == set(want), path
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_same_metrics(got[key], w, f"{path}{key}.")
        elif isinstance(w, float):
            assert got[key] == pytest.approx(w, rel=1e-9, nan_ok=True), f"{path}{key}"
        else:
            assert got[key] == w, f"{path}{key}"


# ------------------------------------------------------------ combined table


def test_combined_table_requires_matching_shapes(tenant_data):
    qb, qb1 = tenant_data[0][4], tenant_data[1][4]
    assert combined_table([qb, qb]) is not None
    assert combined_table([qb, dataclasses.replace(qb, ext_bits=8)]) is None
    assert combined_table([]) is None
    tbl = combined_table([qb, qb1])
    n0 = qb.norms.shape[0]
    np.testing.assert_array_equal(tbl.norms[:n0], qb.norms)
    np.testing.assert_array_equal(tbl.norms[n0:], qb1.norms)
    want = ref_serving.combined_table([tenant_data[0][2], tenant_data[1][2]])
    for f in ("binary_codes", "norms", "ip_bar", "ext_codes", "ext_lo", "ext_step"):
        np.testing.assert_array_equal(getattr(tbl, f), getattr(want, f))


def test_cross_tenant_fusion_spans_tenants(tenant_data):
    """One rendezvous flush serves requests of DIFFERENT tenants over the
    one combined table, registered once."""
    cfg = _cfg(buffer_ratio=0.2, n_workers=2, batch_size=8, fuse=True, fuse_rows=128,
               shared_rendezvous=True)
    plane = ServingPlane([_spec(tenant_data, 0, "velo"), _spec(tenant_data, 1, "velo")], cfg)
    assert plane.table is not None
    run = plane.run(workload_mod.uniform_mix([30, 30], 60, seed=1))
    assert run.stats.cross_tenant_flushes > 0
    assert plane.dist.stats.uploads == 1


# ------------------------------------------------------------ soft quotas


def test_tenant_quota_caps_ownership_and_keeps_invariants(tenant_data):
    params = SearchParams(L=32, W=4)
    specs = [_spec(tenant_data, 0, "velo", params), _spec(tenant_data, 1, "velo", params)]
    cfg = _cfg(buffer_ratio=0.12, n_workers=2, batch_size=4, tenant_quota=0.4)
    plane = ServingPlane(specs, cfg)
    run = plane.run(workload_mod.zipfian_mix([30, 30], 120, s=1.8, seed=0))
    pool = plane.pool
    pool.check_invariants()
    assert pool.tenant_cap is not None and (pool.tenant_owned <= pool.tenant_cap).all()
    assert run.stats.quota_reclaims > 0
    for tr in run.tenants:
        assert tr.recall is None or tr.recall > 0.6


def test_quota_off_is_pure_global_clock(tenant_data):
    cfg = _cfg(buffer_ratio=0.12, batch_size=1, params=PARITY_PARAMS)
    plane = ServingPlane([_spec(tenant_data, 0, "velo"), _spec(tenant_data, 1, "velo")], cfg)
    run = plane.run(workload_mod.uniform_mix([30, 30], 40, seed=5))
    assert run.stats.quota_reclaims == 0 and run.stats.quota_denials == 0
    assert plane.pool.tenant_cap is None
    plane.pool.check_invariants()
    assert int(plane.pool.tenant_owned.sum()) == plane.pool.occupancy()


def test_shared_pool_hot_tenant_hit_rate_beats_partition(tenant_data):
    params = SearchParams(L=32, W=4)
    specs = [_spec(tenant_data, 0, "velo", params), _spec(tenant_data, 1, "velo", params)]
    cfg = _cfg(buffer_ratio=0.12, n_workers=2, batch_size=4)
    wload = workload_mod.zipfian_mix([30, 30], 120, s=1.8, seed=0)
    hot = int(wload.counts().argmax())
    rates = {}
    for shared in (True, False):
        run = ServingPlane(specs, cfg, shared_pool=shared).run(wload)
        rates[shared] = run.tenants[hot].stats.hit_rate
        for tr in run.tenants:
            assert tr.recall is None or tr.recall > 0.6, (tr.name, tr.recall)
    assert rates[True] >= rates[False], rates


# ------------------------------------------------------ accounting and metrics


def test_plane_pressure_counters_not_double_counted(tenant_data):
    params = SearchParams(L=32, W=4)
    specs = [_spec(tenant_data, 0, "velo", params), _spec(tenant_data, 1, "velo", params)]
    plane = ServingPlane(specs, _cfg(buffer_ratio=0.2, n_workers=4, batch_size=8))
    run = plane.run(workload_mod.zipfian_mix([30, 30], 80, s=1.4, seed=0))
    assert run.stats.lock_waits == plane.pool.lock_waits
    assert run.stats.coalesced_record_loads == plane.pool.coalesced_record_loads
    assert run.stats.lock_waits > 0


def test_plane_run_stats_idempotent(tenant_data):
    plane = ServingPlane([_spec(tenant_data, 0, "velo"), _spec(tenant_data, 1, "velo")],
                         _cfg(buffer_ratio=0.2, batch_size=4))
    wload = workload_mod.uniform_mix([30, 30], 40, seed=2)
    r1, r2 = plane.run(wload), plane.run(wload)
    for a, b in zip(r1.tenants, r2.tenants):
        tot1 = a.stats.cache_hits + a.stats.cache_misses
        tot2 = b.stats.cache_hits + b.stats.cache_misses
        assert tot2 < 1.5 * tot1, (tot1, tot2)
        assert b.stats.n_queries == a.stats.n_queries


def test_evaluate_plane_reports_per_tenant_metrics(tenant_data):
    specs = [_spec(tenant_data, 0, "velo", None), _spec(tenant_data, 1, "diskann", None)]
    plane = ServingPlane(specs, _cfg(buffer_ratio=0.2, batch_size=4))
    res = evaluate_plane(plane, workload_mod.uniform_mix([30, 30], 40, seed=0))
    assert set(res["tenants"]) == {"t0", "t1"} and res["distance_backend"] == "torch"
    for t in res["tenants"].values():
        assert t["recall@k"] > 0.5 and 0.0 <= t["hit_rate"] <= 1.0 and t["n_queries"] > 0
    assert plane.batch_size == 1  # diskann forces the shared engine to B=1


def test_per_tenant_latency_split_survives_priority_reordering(tenant_data):
    params = SearchParams(L=32, W=4)
    specs = [_spec(tenant_data, 0, "velo", params), _spec(tenant_data, 1, "velo", params)]
    cfg = _cfg(buffer_ratio=0.2, n_workers=2, batch_size=4, fuse=True, fuse_rows=64,
               scheduler="sla", sla_ms=[5.0, 1.0], sla_feedback=False)
    plane = ServingPlane(specs, cfg)
    wl = workload_mod.bursty_mix([30, 30], 80, mean_burst=8, seed=1, qps=20000.0)
    run = plane.run(wl)
    stats = run.stats
    assert stats.latency_qids != sorted(stats.latency_qids)
    assert len(stats.latencies) == len(wl)
    lat_by_qid = dict(zip(stats.latency_qids, stats.latencies))
    for tr, tid in zip(run.tenants, (0, 1)):
        pos = list(wl.positions(tid))
        assert list(tr.stats.latency_qids) == pos
        assert tr.stats.latencies == [lat_by_qid[i] for i in pos]
        assert tr.stats.deadline_hits + tr.stats.deadline_misses == tr.stats.n_queries
    assert sum(t.stats.deadline_hits for t in run.tenants) == stats.deadline_hits
    assert sum(t.stats.queue_wait_s for t in run.tenants) == pytest.approx(stats.queue_wait_s)


def test_workload_for_more_tenants_than_the_plane_is_refused(tenant_data):
    plane = ServingPlane([_spec(tenant_data, 0, "velo")], _cfg(buffer_ratio=0.2, batch_size=4))
    with pytest.raises(AssertionError, match="tenants"):
        plane.run(workload_mod.uniform_mix([30, 30], 10, seed=0))


@pytest.mark.parametrize("shared", [True, False])
def test_verify_protocol_is_bitwise_inert(tenant_data, shared):
    """A plane with ``verify_protocol=True`` arms one checker over the shared
    pool (or every tenant's own pool under a static partition), runs with no
    violation, and returns the unverified plane's results bit for bit and
    the verified reference plane's ids, hops and reads."""
    def run(verify, ref=False):
        specs = [_spec(tenant_data, i, "velo", ref=ref) for i in range(2)]
        cfg = _cfg(ref_baselines if ref else baselines, buffer_ratio=0.2, batch_size=4,
                   tenant_quota=0.6 if shared else None, verify_protocol=verify)
        plane = (ref_serving.ServingPlane if ref else ServingPlane)(specs, cfg,
                                                                     shared_pool=shared)
        wl = (ref_workload if ref else workload_mod).zipfian_mix([30, 30], 40, s=1.5, seed=0)
        return plane, plane.run(wl)

    _, plain = run(False)
    plane, got = run(True)
    ref_plane, want = run(True, ref=True)
    assert plane.checker is not None and plane.checker.ok() and plane.checker.flushes > 0
    assert len(plane.checker._pools) == (1 if shared else 2)
    ref_plane.checker.raise_if_violations()
    for t0, t1, tr in zip(plain.tenants, got.tenants, want.tenants):
        _assert_bitwise(t0.results, t1.results, f"verified shared={shared}")
        _assert_matches_reference(tr.results, t1.results, f"reference shared={shared}")
