"""The port's distance plane (``TorchEngine`` on the CPU) against the JAX
package's ``PallasEngine`` (interpret mode) and ``BatchEngine``.

Both sides search one index image: the reference's build artifacts carried
across with ``convert.index_from_reference``.  Tolerances, with reasons:
  * vs ``pallas``: both evaluate the estimator and the refine in float32, in
    another summation order — rtol 1e-5 / atol 1e-4 (test_kernels.py's bar);
  * vs ``batch``: the NumPy estimator mixes float64 into the epilogue —
    rtol 2e-3 / atol 2e-3 (test_distance.py's bar);
  * bitwise where both sides run the same NumPy code (ext_bits=8, counters,
    beam selections).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import beam as ref_beam
from repro.core import distance as ref_distance
from repro.core.quant import RabitQuantizer as RefQuantizer
from repro_torch import convert
from repro_torch.core import beam as beam_mod
from repro_torch.core import distance as distance_mod
from repro_torch.core import hbm as hbm_mod
from repro_torch.core.quant import RabitQuantizer

pytest.importorskip("jax")

F32 = dict(rtol=1e-5, atol=1e-4)
HOST = dict(rtol=2e-3, atol=2e-3)


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
def port_qb(small_qb, small_graph):
    return convert.index_from_reference(_fields(small_qb), _fields(small_graph))[0]


@pytest.fixture(scope="module")
def queries(small_ds, small_qb, port_qb):
    """(reference PreparedQuery, port PreparedQuery) pairs."""
    return [
        (RefQuantizer.prepare_query(small_qb, q), RabitQuantizer.prepare_query(port_qb, q))
        for q in small_ds.queries[:4]
    ]


def _ids(m, seed):
    return np.random.default_rng(seed).integers(0, 1500, m)


# ------------------------------------------------------------ id-based paths


@pytest.mark.parametrize("m", [1, 7, 64, 65, 200])
def test_resident_primitives_match_reference(m, small_qb, port_qb, queries):
    eng = distance_mod.get_engine("torch", device="cpu")
    pallas = ref_distance.get_engine("pallas")
    batch = ref_distance.get_engine("batch")
    (rpq, pq) = queries[0]
    ids = _ids(m, m)
    got = eng.estimate(port_qb, pq, ids)
    assert got.dtype == np.float32 and got.shape == (m,)
    np.testing.assert_allclose(got, pallas.estimate(small_qb, rpq, ids), **F32)
    np.testing.assert_allclose(got, batch.estimate(small_qb, rpq, ids), **HOST)
    got = eng.refine_ids(port_qb, pq, ids)
    np.testing.assert_allclose(got, pallas.refine_ids(small_qb, rpq, ids), **F32)
    np.testing.assert_allclose(got, batch.refine_ids(small_qb, rpq, ids), **HOST)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(pallas.stats)


def test_fused_many_paths_match_reference(small_qb, port_qb, queries):
    eng = distance_mod.get_engine("torch", device="cpu")
    pallas = ref_distance.get_engine("pallas")
    sizes = [5, 0, 64, 17]
    id_groups = [_ids(s, 10 + i) for i, s in enumerate(sizes)]
    for fn in ("estimate_many", "refine_ids_many"):
        got = getattr(eng, fn)(port_qb, [(pq, i) for (_, pq), i in zip(queries, id_groups)])
        want = getattr(pallas, fn)(small_qb, [(r, i) for (r, _), i in zip(queries, id_groups)])
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **F32)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(pallas.stats)
    assert eng.stats.fused_calls == 2 and eng.stats.uploads == 1


def test_uploads_are_once_per_index(small_ds, port_qb, queries):
    eng = distance_mod.get_engine("torch", device="cpu")
    pq = queries[0][1]
    for k in range(12):
        eng.estimate(port_qb, pq, _ids(33, k))
        eng.refine_ids(port_qb, pq, _ids(33, k))
    assert eng.stats.uploads == 1 and eng.stats.resident_gathers == 12 * 2 * 33
    eng.register_index(port_qb)
    assert eng.stats.uploads == 1
    qb2 = RabitQuantizer(small_ds.dim, seed=7).fit_encode(small_ds.base)
    eng.estimate(qb2, RabitQuantizer.prepare_query(qb2, small_ds.queries[0]), _ids(9, 1))
    assert eng.stats.uploads == 2


# ------------------------------------------------------------- matrix paths


def test_matrix_paths_match_reference_and_count_uploads(small_qb, port_qb, queries):
    """resident=False: every kernel call ships its gathered rows (one upload
    each), exactly as the reference's non-resident pallas engine counts."""
    eng = distance_mod.get_engine("torch", resident=False, device="cpu")
    pallas = ref_distance.get_engine("pallas", resident=False)
    (rpq, pq), (rpq2, pq2) = queries[:2]
    for k in range(3):
        ids = _ids(20 + k, k)
        np.testing.assert_allclose(eng.estimate(port_qb, pq, ids),
                                   pallas.estimate(small_qb, rpq, ids), **F32)
        rows = (small_qb.ext_codes[ids], small_qb.ext_lo[ids], small_qb.ext_step[ids])
        np.testing.assert_allclose(eng.refine(port_qb, pq, *rows),
                                   pallas.refine(small_qb, rpq, *rows), **F32)
        got = eng.refine_many(port_qb, [(pq, *rows), (pq2, *rows)])
        want = pallas.refine_many(small_qb, [(rpq, *rows), (rpq2, *rows)])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **F32)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(pallas.stats)
    assert eng.stats.uploads == 1 + 3 * 3


def test_ext8_refine_takes_the_numpy_path(small_ds):
    qb8 = RabitQuantizer(small_ds.dim, seed=0, ext_bits=8).fit_encode(small_ds.base)
    pq = RabitQuantizer.prepare_query(qb8, small_ds.queries[0])
    ids = _ids(40, 3)
    got = distance_mod.get_engine("torch", device="cpu").refine_ids(qb8, pq, ids)
    np.testing.assert_array_equal(
        got, distance_mod.get_engine("batch").refine_ids(qb8, pq, ids))


def test_empty_batches_are_not_charged(port_qb, queries):
    eng = distance_mod.get_engine("torch", device="cpu")
    pq = queries[0][1]
    assert eng.estimate(port_qb, pq, np.empty(0, np.int64)).shape == (0,)
    assert eng.refine_ids(port_qb, pq, np.empty(0, np.int64)).shape == (0,)
    assert eng.stats.level1_calls == 0 and eng.stats.level2_calls == 0


# ----------------------------------------------------- HBM tier slot gathers


def _tiers(small_qb, port_qb, vids):
    from repro.core import hbm as ref_hbm
    from repro.core.store import DecodedRecord as RefRecord
    from repro_torch.core.store import DecodedRecord

    n = small_qb.norms.shape[0]
    v2p = np.arange(n, dtype=np.int32)
    ref_t = ref_hbm.HbmTier(small_qb, v2p, n_slots=32, R=20)
    port_t = hbm_mod.HbmTier(port_qb, v2p, n_slots=32, R=20)
    for v in vids:
        adj = np.arange(3, dtype=np.int64)
        ref_t.note_publish(int(v), RefRecord(int(v), adj, small_qb.record_payload(int(v))))
        port_t.note_publish(int(v), DecodedRecord(int(v), adj, port_qb.record_payload(int(v))))
    return ref_t, port_t


def test_refine_slots_match_reference_with_zero_upload(small_qb, port_qb, queries):
    vids = np.asarray([2, 9, 17, 30, 41])
    ref_t, port_t = _tiers(small_qb, port_qb, vids)
    eng = distance_mod.get_engine("torch", device="cpu")
    pallas = ref_distance.get_engine("pallas")
    # the device mirror exists before the scatter: the scatter must update it
    port_t.device_arrays(eng.device)
    ref_t.device_arrays()
    assert port_t.scatter_staged() == ref_t.scatter_staged() == len(vids)
    for mirror, host in zip(port_t.device_arrays(eng.device),
                            (port_t.cache.cache_ext, port_t.cache.cache_lo,
                             port_t.cache.cache_step)):
        assert np.array_equal(mirror.numpy(), host)
        assert not np.shares_memory(mirror.numpy(), host)
    slots = port_t.cache.record_map[vids].astype(np.int64)
    assert np.array_equal(slots, ref_t.cache.record_map[vids])
    eng.register_index(port_qb)
    (rpq, pq), (rpq2, pq2) = queries[:2]
    got = eng.refine_slots(port_t, pq, slots)
    np.testing.assert_allclose(got, pallas.refine_slots(ref_t, rpq, slots), **F32)
    np.testing.assert_allclose(got, eng.refine_ids(port_qb, pq, vids), rtol=1e-6, atol=1e-6)
    got = eng.refine_slots_many(port_t, [(pq, slots), (pq2, slots[:3])])
    want = pallas.refine_slots_many(ref_t, [(rpq, slots), (rpq2, slots[:3])])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32)
    assert eng.stats.uploads == 1 and eng.stats.slot_gathers == 5 + 8


# --------------------------------------------------------- fused beam steps


def _req(mod, qb, pq, state, fresh=(), explored=(), insert_ids=(), insert_ds=(), topk=0):
    fresh = np.asarray(fresh, np.int64)
    return mod.BeamRequest(
        kind="estimate", state=state, fresh=fresh,
        explored=np.asarray(explored, np.int64),
        insert_ids=np.asarray(insert_ids, np.int64),
        insert_ds=np.asarray(insert_ds, np.float32),
        rows=int(fresh.size), flop_s=0.0, pq=pq, qb=qb, topk=int(topk),
    )


# A hostile sequence per query: seed inserts, duplicate frontiers, visited
# re-submissions, explored marks emptying the frontier, a frontier wider
# than the beam, and a final heap readout (topk) that leaves the fused path.
STEPS = [
    [dict(fresh=[0], insert_ids=[0], insert_ds=[0.0]),
     dict(fresh=[5, 9, 5, 14, 9, 9]),
     dict(fresh=[5, 9, 14], explored=[5]),
     dict(fresh=list(range(20, 60)), explored=[9, 14]),
     dict(fresh=[61, 62, 3], explored=[0, 20, 21]),
     dict(fresh=[70], topk=8)],
    [dict(fresh=[100, 101], insert_ids=[100], insert_ds=[1.5]),
     dict(fresh=list(range(102, 140, 2)), explored=[100]),
     dict(fresh=[]),
     dict(fresh=[101, 3, 4], explored=[101, 102]),
     dict(fresh=list(range(700, 720)), insert_ids=[5], insert_ds=[0.1]),
     dict(fresh=[7, 8], topk=8)],
    [dict(fresh=list(range(1400, 1499))),
     dict(fresh=[1499, 0, 1], explored=[1400]),
     dict(fresh=[2], explored=[1401, 1402, 1403]),
     dict(fresh=[1, 2, 3]),
     dict(fresh=[600], insert_ids=[601], insert_ds=[9.0]),
     dict(fresh=[], topk=4)],
]


@pytest.mark.parametrize("fused", [False, True])
def test_beam_steps_match_reference_fused_step(fused, small_qb, port_qb, queries):
    """Identical frontiers and window lengths, tails to float32 rounding, on
    the reference's single-jitted-call beam step — step by step, either one
    query per call or all three in one fused call."""
    L, n = 8, 1500
    eng = distance_mod.get_engine("torch", device="cpu")
    pallas = ref_distance.get_engine("pallas")
    st = [eng.beam_new(L, n) for _ in STEPS]
    rst = [pallas.beam_new(L, n) for _ in STEPS]
    assert all(s.backend == "device" and isinstance(s.visited, torch.Tensor) for s in st)
    for k in range(len(STEPS[0])):
        reqs = [_req(beam_mod, port_qb, queries[i][1], st[i], **STEPS[i][k]) for i in range(3)]
        rreqs = [_req(ref_beam, small_qb, queries[i][0], rst[i], **STEPS[i][k]) for i in range(3)]
        if fused:
            got, want = eng.beam_step_many(port_qb, reqs), pallas.beam_step_many(small_qb, rreqs)
        else:
            got = [eng.beam_step(port_qb, r) for r in reqs]
            want = [pallas.beam_step(small_qb, r) for r in rreqs]
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.frontier, w.frontier, f"step {k} query {i}")
            assert g.window_len == w.window_len, f"step {k} query {i}"
            np.testing.assert_allclose(g.tail, w.tail, **F32)
            if w.topk_ids is not None:
                np.testing.assert_array_equal(g.topk_ids, w.topk_ids)
                np.testing.assert_allclose(g.topk_ds, w.topk_ds, **F32)
    for s, r in zip(st, rst):
        assert np.array_equal(s.cand_v.numpy(), np.asarray(r.cand_v, np.int64))
        assert np.array_equal(s.visited.numpy(), np.asarray(r.visited))
        assert np.array_equal(s.explored.numpy(), np.asarray(r.explored))
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(pallas.stats)


def test_beam_host_view_hands_out_copies(port_qb, queries):
    """On the CPU Tensor.numpy() aliases the tensor: the host view the
    generic path mutates must be a copy, or it would corrupt the state."""
    eng = distance_mod.get_engine("torch", device="cpu")
    st = eng.beam_new(4, 50)
    eng.beam_step(port_qb, _req(beam_mod, port_qb, queries[0][1], st, fresh=[1, 2]))
    _, _, visited, explored = eng._beam_host_view(st)
    before = (st.visited.clone(), st.explored.clone())
    visited[:] = True
    explored[:] = True
    assert torch.equal(st.visited, before[0]) and torch.equal(st.explored, before[1])
    assert not bool(st.explored[:50].any())


# --------------------------------------------------------------- selection


def test_get_engine_selection_rules():
    assert distance_mod.BACKENDS == ("scalar", "batch", "torch")
    assert distance_mod.default_backend() == "torch"
    assert distance_mod.get_engine("scalar").name == "scalar"
    assert distance_mod.get_engine("batch").name == "batch"
    eng = distance_mod.get_engine(None)
    assert eng.name == "torch" and eng.device == torch.device("cpu")
    for name in ("pallas", "auto", "not-a-backend"):
        with pytest.raises(ValueError):
            distance_mod.get_engine(name)
        with pytest.raises(ValueError):
            distance_mod.set_default_backend(name)


def test_torch_engine_without_cuda_raises():
    """No silent CPU route: with no card, the default device fails loudly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    old = distance_mod.default_device()
    distance_mod.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            distance_mod.get_engine("torch")
        with pytest.raises(RuntimeError, match="CUDA"):
            distance_mod.get_engine("torch", device="cuda:0")
    finally:
        distance_mod.set_default_device(old)
