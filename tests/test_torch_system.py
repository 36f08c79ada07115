"""The port's systems end to end against the JAX package.

The bar of tests/test_distance.py::test_backend_parity_all_algorithms: the
port's ``build_system(algo, distance_backend="torch", device="cpu")``, run on
the reference's index carried across with ``convert``, returns the SAME
ids, hops and reads as the reference, with dists within rtol 2e-3 / atol
2e-3 (the NumPy estimator mixes float64 into its epilogue; the torch path
is float32 throughout).  Against the reference's ``batch`` backend for all
five algorithms, and for velo also against its ``pallas`` backend with
fuse, device_beam and the HBM tier switched — where every DistanceStats
counter must match too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core.search import ALGORITHMS as REF_ALGORITHMS
from repro_torch import convert
from repro_torch.core import baselines, dataset, vamana
from repro_torch.core import distance as distance_mod
from repro_torch.core.quant import RabitQuantizer
from repro_torch.core.search import ALGORITHMS

N_QUERIES = 16


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


def _cfg(mod, backend, **kw):
    return mod.SystemConfig(
        buffer_ratio=0.2, batch_size=4, distance_backend=backend,
        params=mod.SearchParams(L=32, W=4), **kw,
    )


def _runs(algo, small_ds, small_graph, small_qb, carried, ref_backend, **kw):
    qb, graph = carried
    ref_sys = ref_baselines.build_system(
        algo, small_ds.base, small_graph, small_qb, _cfg(ref_baselines, ref_backend, **kw))
    want, _ = ref_sys.run(small_ds.queries[:N_QUERIES])
    sys_ = baselines.build_system(
        algo, small_ds.base, graph, qb, _cfg(baselines, "torch", device="cpu", **kw))
    got, _ = sys_.run(small_ds.queries[:N_QUERIES])
    assert sys_.ctx.dist.name == "torch" and sys_.ctx.dist.device == torch.device("cpu")
    return want, got, ref_sys, sys_


def _assert_same_results(want, got, tag):
    assert len(want) == len(got)
    for i, (r0, r1) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(r0.ids, r1.ids, err_msg=f"{tag} query {i}: ids")
        assert r0.hops == r1.hops, f"{tag} query {i}: hops"
        assert r0.reads == r1.reads, f"{tag} query {i}: reads"
        np.testing.assert_allclose(r0.dists, r1.dists, rtol=2e-3, atol=2e-3,
                                   err_msg=f"{tag} query {i}: dists")


def test_same_algorithm_set():
    assert sorted(ALGORITHMS) == sorted(REF_ALGORITHMS)


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_backend_parity_all_algorithms(algo, small_ds, small_graph, small_qb, carried):
    want, got, _, sys_ = _runs(algo, small_ds, small_graph, small_qb, carried, "batch")
    _assert_same_results(want, got, f"{algo}/torch-vs-batch")
    assert sys_.ctx.dist.stats.uploads == (0 if algo == "inmemory" else 1)


@pytest.mark.parametrize("fuse,device_beam,hbm_tier", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, False), (False, False, True), (True, False, True),
])
def test_velo_matches_reference_pallas(fuse, device_beam, hbm_tier,
                                       small_ds, small_graph, small_qb, carried):
    pytest.importorskip("jax")
    want, got, ref_sys, sys_ = _runs(
        "velo", small_ds, small_graph, small_qb, carried, "pallas",
        fuse=fuse, device_beam=device_beam, hbm_tier=hbm_tier)
    _assert_same_results(want, got, f"velo fuse={fuse} beam={device_beam} hbm={hbm_tier}")
    assert dataclasses.asdict(sys_.ctx.dist.stats) == dataclasses.asdict(ref_sys.ctx.dist.stats)
    assert sys_.ctx.dist.stats.uploads == 1
    if hbm_tier:
        assert sys_.hbm is not None and sys_.ctx.dist.stats.slot_gathers > 0
        assert sys_.hbm.counters() == ref_sys.hbm.counters()


def test_evaluate_matches_reference(small_ds, small_graph, small_qb, carried):
    """``evaluate`` over the whole query set reports the reference's metrics:
    recall, simulated QPS and latency, I/O and hit rates, dispatch counts."""
    qb, graph = carried
    kw = dict(fuse=True, device_beam=True)
    want = ref_baselines.evaluate(ref_baselines.build_system(
        "velo", small_ds.base, small_graph, small_qb, _cfg(ref_baselines, "batch", **kw)),
        small_ds)
    got = baselines.evaluate(baselines.build_system(
        "velo", small_ds.base, graph, qb, _cfg(baselines, "torch", device="cpu", **kw)),
        small_ds)
    assert got.pop("distance_backend") == "torch" and want.pop("distance_backend") == "batch"
    assert got == want
    assert got["dist_uploads"] == 1


def test_quickstart_flow_at_fixture_size():
    """examples/quickstart.py's flow on the port alone: build -> evaluate."""
    ds = dataset.make_dataset(n=1500, d=64, n_queries=60, k=10, seed=0)
    graph = vamana.build_vamana(ds.base, R=20, L=40, batch_size=256, seed=0)
    qb = RabitQuantizer(ds.dim, seed=0).fit_encode(ds.base)
    cfg = baselines.SystemConfig(
        buffer_ratio=0.2, batch_size=8, device="cpu",
        params=baselines.SearchParams(L=48, W=4))
    assert cfg.distance_backend == "torch"
    out = baselines.evaluate(baselines.build_system("velo", ds.base, graph, qb, cfg), ds)
    assert out["distance_backend"] == "torch"
    assert out["recall@k"] > 0.6 and out["qps"] > 0 and out["dist_uploads"] == 1


def test_verify_protocol_is_not_ported(small_ds, carried):
    qb, graph = carried
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        baselines.build_system("velo", small_ds.base, graph, qb,
                               _cfg(baselines, "torch", device="cpu", verify_protocol=True))
