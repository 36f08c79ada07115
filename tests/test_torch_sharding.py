"""Sharded scatter-gather serving on the port's ``torch`` engine (CPU).

The load-bearing contract (docs/sharding.md): with ONE shard the sharded
engine is bitwise the unsharded engine — same ids, dists, hops, makespan
and per-query latencies — for all five algorithms in both fuse modes, here
also with ``device_beam`` on.  Across shard counts velo keeps its recall
flat (with ``device_beam`` on, its multi-shard steps go through the
engine's ``beam_score_local_many`` and ``beam_finalize`` with ``BeamState``s
held as tensors) and diskann its results bitwise; and the sharded port returns the reference's sharded
results (ids, hops, reads; dists within tests/test_torch_system.py's bar).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import dataset as ref_dataset
from repro.core import vamana as ref_vamana
from repro.core.quant import RabitQuantizer as RefQuantizer
from repro_torch import convert
from repro_torch.core import baselines, dataset
from repro_torch.core import distance as distance_mod
from repro_torch.core.search import ALGORITHMS, SearchParams

ALGOS = sorted(ALGORITHMS)


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    old = distance_mod.default_device()
    distance_mod.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    distance_mod.set_default_device(old)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_sharding.py's index, built by the reference and carried
    across: (ds, ref graph, ref qb, graph, qb)."""
    ds = ref_dataset.make_dataset(n=600, d=32, n_queries=12, k=10, seed=4)
    graph = ref_vamana.build_vamana(ds.base, R=12, L=24, batch_size=256, seed=4)
    qb = RefQuantizer(32, seed=4).fit_encode(ds.base)
    fields = [{f.name: getattr(o, f.name) for f in dataclasses.fields(o)} for o in (qb, graph)]
    port_qb, port_graph = convert.index_from_reference(*fields)
    return ds, graph, qb, port_graph, port_qb


def _cfg(mod, n_shards, fuse, device_beam=False, n_workers=1):
    kw = dict(device="cpu") if mod is baselines else dict(distance_backend="batch")
    return mod.SystemConfig(buffer_ratio=0.2, n_workers=n_workers, batch_size=4, fuse=fuse,
                            device_beam=device_beam, n_shards=n_shards,
                            params=mod.SearchParams(L=24, W=4), **kw)


def _run(tiny, algo, n_shards, fuse, device_beam=False, calls=None):
    """Build and run; with ``calls`` (a dict), count the engine's sharded
    beam entries (``beam_score_local_many``, ``beam_finalize``) into it."""
    ds, _, _, graph, qb = tiny
    sys_ = baselines.build_system(algo, ds.base, graph, qb,
                                  _cfg(baselines, n_shards, fuse, device_beam))
    assert sys_.ctx.dist.name == "torch"
    if calls is not None:
        eng = sys_.ctx.dist
        for name in ("beam_score_local_many", "beam_finalize"):
            def counted(*a, _fn=getattr(eng, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(eng, name, counted)
    return (sys_, *sys_.run(ds.queries))


def _recall(results, ds):
    ids = np.full((len(results), 10), -1, dtype=np.int64)
    for i, r in enumerate(results):
        ids[i, : min(10, len(r.ids))] = r.ids[:10]
    return dataset.recall_at_k(ids, ds.groundtruth, 10)


def _proj(results):
    return [(list(r.ids), list(r.dists), r.hops) for r in results]


@pytest.mark.parametrize("device_beam", [False, True], ids=["host_beam", "device_beam"])
@pytest.mark.parametrize("fuse", [False, True], ids=["nofuse", "fuse"])
@pytest.mark.parametrize("algo", ALGOS)
def test_s1_bitwise_parity_with_unsharded(algo, fuse, device_beam, tiny):
    _, ref, ref_stats = _run(tiny, algo, None, fuse, device_beam)
    sys_s, got, got_stats = _run(tiny, algo, 1, fuse, device_beam)
    label = f"{algo}/fuse={fuse}/device_beam={device_beam}"
    assert _proj(got) == _proj(ref), f"{label}: sharded S=1 diverged from unsharded"
    assert got_stats.makespan_s == ref_stats.makespan_s, label
    assert got_stats.latencies == ref_stats.latencies, label
    assert got_stats.scatter_ops > 0, f"{label}: scatter path never taken"
    assert sys_s.shard_plan is not None
    if device_beam and algo == "velo":
        assert sys_s.ctx.dist.stats.beam_steps > 0


def test_diskann_bitwise_stable_across_shard_counts(tiny):
    _, ref, _ = _run(tiny, "diskann", 1, True)
    for S in (2, 4):
        _, got, stats = _run(tiny, "diskann", S, True)
        assert _proj(got) == _proj(ref), f"S={S}"
        assert stats.shard_flushes > 0 and stats.shard_merges > 0


@pytest.mark.parametrize("device_beam", [False, True], ids=["host_beam", "device_beam"])
@pytest.mark.parametrize("fuse", [False, True], ids=["nofuse", "fuse"])
def test_velo_recall_flat_across_shard_counts(fuse, device_beam, tiny):
    ds = tiny[0]
    base = _recall(_run(tiny, "velo", 1, fuse, device_beam)[1], ds)
    for S in (2, 4):
        calls = {}
        sys_, got, stats = _run(tiny, "velo", S, fuse, device_beam, calls)
        rec = _recall(got, ds)
        assert abs(rec - base) <= 0.05, f"S={S}: {rec:.3f} vs {base:.3f}"
        assert stats.scatter_ops > 0 and stats.shard_merges > 0
        if fuse:
            assert stats.shard_flushes > 0
        if device_beam:  # multi-shard beam steps: local top-Ls, then one finalize
            assert calls.get("beam_score_local_many", 0) > 0, calls
            assert calls.get("beam_finalize", 0) > 0, calls


@pytest.mark.parametrize("algo,n_shards,fuse", [
    ("velo", 2, True), ("velo", 4, False), ("diskann", 2, True), ("pipeann", 4, True),
])
def test_sharded_port_matches_sharded_reference(algo, n_shards, fuse, tiny):
    ds, rgraph, rqb, _, _ = tiny
    want, _ = ref_baselines.build_system(
        algo, ds.base, rgraph, rqb, _cfg(ref_baselines, n_shards, fuse)).run(ds.queries)
    _, got, _ = _run(tiny, algo, n_shards, fuse)
    for i, (r0, r1) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(r0.ids, r1.ids, err_msg=f"q{i}")
        assert (r0.hops, r0.reads) == (r1.hops, r1.reads), f"q{i}"
        np.testing.assert_allclose(r0.dists, r1.dists, rtol=2e-3, atol=2e-3)
