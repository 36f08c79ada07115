"""The port's span recorder (``repro_torch.tracing``) on the CPU.

It is off by default and then records nothing; with it on a search returns
bitwise what it returns with it off; a velo run yields a span of every
instrumented layer, each ``search.step`` with its query, nested spans whose
self times add up to the run's total; and the distance plane counts its
host <-> device copies exactly.  The kernel wrappers' ``kernels.launch``
spans run only on a card (``cuda``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import baselines, dataset, vamana
from repro_torch.core import distance as distance_mod
from repro_torch.core.quant import RabitQuantizer
from repro_torch.kernels.binary_ip import kernel as bip_kernel
from repro_torch.kernels.int4_dist import kernel as i4_kernel

N_QUERIES = 8
HOST_SPANS = {"engine.run", "search.step", "store.decode", "pool.admit",
              "distance.execute", "distance.h2d", "distance.d2h"}


@pytest.fixture(scope="module")
def index():
    torch.set_num_threads(1)
    ds = dataset.make_dataset(n=200, d=32, n_queries=N_QUERIES, k=5, seed=1)
    graph = vamana.build_vamana(ds.base, R=8, L=16, seed=1)
    qb = RabitQuantizer(ds.dim, seed=1).fit_encode(ds.base)
    return ds, graph, qb


def _system(index, device="cpu"):
    ds, graph, qb = index
    cfg = baselines.SystemConfig(buffer_ratio=0.2, batch_size=4, n_workers=2, device=device,
                                 params=baselines.SearchParams(k=5, L=16, W=2))
    return baselines.build_system("velo", ds.base, graph, qb, cfg)


def _traced(fn):
    tracing.start()
    try:
        out = fn()
    finally:
        rec = tracing.stop()
    return out, rec


def _self_sum(rec) -> int:
    return sum(s for _, _, s in rec.totals.values())


def test_off_by_default_records_nothing(index):
    assert tracing.on is False
    tracing.start()
    tracing.stop()  # empties the recorder
    _system(index).run(index[0].queries)
    rec = tracing.stop()
    assert len(rec) == 0 and rec.totals == {}


def test_results_and_stats_are_bitwise_the_same_on_and_off(index):
    off = _system(index)
    want, want_stats = off.run(index[0].queries)
    on = _system(index)
    (got, got_stats), rec = _traced(lambda: on.run(index[0].queries))
    assert len(rec) > 0
    for r0, r1 in zip(want, got, strict=True):
        np.testing.assert_array_equal(r0.ids, r1.ids)
        np.testing.assert_array_equal(r0.dists, r1.dists)
        assert (r0.hops, r0.reads) == (r1.hops, r1.reads)
    assert dataclasses.asdict(want_stats) == dataclasses.asdict(got_stats)
    assert dataclasses.asdict(off.ctx.dist.stats) == dataclasses.asdict(on.ctx.dist.stats)
    assert off.ctx.accessor.pool.evictions == on.ctx.accessor.pool.evictions > 0


def test_a_run_yields_every_host_span_with_its_query(index):
    system = _system(index)
    _, rec = _traced(lambda: system.run(index[0].queries))
    assert set(rec.totals) == HOST_SPANS  # kernels.launch only on a card
    assert rec.totals["engine.run"][0] == 1
    names = [rec.names[n] for n in rec.name]
    steps = [i for i, n in enumerate(names) if n == "search.step"]
    assert {rec.request(i) for i in steps} == {(0, q) for q in range(N_QUERIES)}
    for i, n in enumerate(names):
        p = rec.parent[i]
        if n == "engine.run":
            assert p == -1 and rec.request(i) == -1
            continue
        assert p >= 0 and rec.t0[p] <= rec.t0[i] <= rec.t1[i] <= rec.t1[p]
        if n != "search.step":
            # a span inherits its enclosing query: decode and admit inside a
            # step carry the step's query, those of the engine's callbacks none
            assert rec.qid[i] == rec.qid[p]
    assert any(names[i] in ("store.decode", "pool.admit") and names[rec.parent[i]] == "search.step"
               for i in range(len(rec)))
    # every port span nests in engine.run: the self times add up to its total
    assert _self_sum(rec) == rec.totals["engine.run"][1]


def test_self_time_plus_children_is_the_total():
    a, b, c = (tracing.name(f"test.{x}") for x in "abc")
    tracing.start()
    s0 = tracing.begin(a, 7)
    s1 = tracing.begin(b)
    tracing.end(s1)
    s2 = tracing.begin(c)
    s3 = tracing.begin(b)
    tracing.end(s3)
    tracing.end(s2)
    s4 = tracing.begin(c)
    tracing.begin(b)  # left open, as an exception would: ends with its parent
    tracing.end(s4)
    tracing.end(s0)
    rec = tracing.stop()
    d = [rec.t1[i] - rec.t0[i] for i in range(len(rec))]
    assert list(rec.parent) == [-1, 0, 0, 2, 0, 4]
    assert list(rec.qid) == [7] * 6 and rec.request(3) == (-1, 7)
    assert rec.t1[5] == rec.t1[4]
    tot = rec.totals
    assert tot["test.a"] == (1, d[0], d[0] - d[1] - d[2] - d[4])
    assert tot["test.b"] == (3, d[1] + d[3] + d[5], d[1] + d[3] + d[5])
    assert tot["test.c"] == (2, d[2] + d[4], d[2] - d[3] + d[4] - d[5])
    assert tot["test.a"][2] + tot["test.b"][1] + tot["test.c"][2] == tot["test.a"][1]
    assert _self_sum(rec) == d[0]
    # the innermost open span at each change point
    times, labels = rec.timeline()
    assert list(times) == sorted(times) and len(labels) == 2 * len(rec)
    assert labels[0] == "test.a" and labels[-1] is None
    j = int(np.searchsorted(times, rec.t0[3], side="right")) - 1
    assert labels[j] == "test.b" and labels[j + 1] == "test.c"


def test_distance_plane_counts_its_host_copies(index):
    ds, _, qb = index
    eng = distance_mod.get_engine("torch", device="cpu")
    eng.register_index(qb)
    pqs = [RabitQuantizer.prepare_query(qb, q) for q in ds.queries[:3]]
    ids = [np.arange(5), np.arange(10, 17), np.arange(40, 41)]
    eng.estimate_many(qb, list(zip(pqs, ids)))
    # one query stack up, one id vector up, one (3, 13) result back
    assert (eng.stats.h2d_copies, eng.stats.d2h_copies) == (2, 1)
    eng.refine_ids_many(qb, list(zip(pqs[:2], ids[:2])))
    assert (eng.stats.h2d_copies, eng.stats.d2h_copies) == (4, 2)
    assert (eng.stats.level1_calls, eng.stats.level2_calls) == (1, 1)


@pytest.mark.cuda
def test_kernel_wrappers_are_spans_on_the_card(index):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    system = _system(index, device="cuda")
    want, want_stats = _system(index, device="cuda").run(index[0].queries)
    n0 = bip_kernel.launches + i4_kernel.launches
    (got, got_stats), rec = _traced(lambda: system.run(index[0].queries))
    launches = bip_kernel.launches + i4_kernel.launches - n0
    assert set(rec.totals) == HOST_SPANS | {"kernels.launch"}
    assert rec.totals["kernels.launch"][0] == launches > 0
    names = [rec.names[n] for n in rec.name]
    assert all(names[rec.parent[i]] == "distance.execute"
               for i, n in enumerate(names) if n == "kernels.launch")
    assert _self_sum(rec) == rec.totals["engine.run"][1]
    for r0, r1 in zip(want, got, strict=True):
        np.testing.assert_array_equal(r0.ids, r1.ids)
        np.testing.assert_array_equal(r0.dists, r1.dists)
    assert dataclasses.asdict(want_stats) == dataclasses.asdict(got_stats)
