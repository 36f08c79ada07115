"""SLA-aware scheduling on the port (``core.scheduling`` + the engine's EDF
mode), on the ``torch`` engine on the CPU, and against the JAX package.

  * rr parity: ``scheduler="rr"`` with a deadline plan is bitwise the
    plan-free run for all five algorithms in both fuse modes (answers,
    makespan, charged switches); equal deadlines make sla bitwise rr;
  * the starvation regression: a cold tenant with a tight SLA under a
    zipfian mix is starved by rr and held by sla, with the same deadline
    hit rates as the reference's plane;
  * plan construction and the feedback controller (pure host logic) give
    the reference's values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import dataset as ref_dataset
from repro.core import scheduling as ref_scheduling
from repro.core import serving as ref_serving
from repro.core import vamana as ref_vamana
from repro.core import workload as ref_workload
from repro.core.quant import RabitQuantizer as RefQuantizer
from repro_torch import convert
from repro_torch.core import baselines
from repro_torch.core import distance as distance_mod
from repro_torch.core import workload as workload_mod
from repro_torch.core.scheduling import SlaController, SlaPlan, sla_seconds
from repro_torch.core.search import ALGORITHMS, SearchParams
from repro_torch.core.serving import ServingPlane, TenantSpec

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
    """tests/test_scheduling.py's index, built by the reference and carried
    across: (ds, ref graph, ref qb, graph, qb)."""
    ds = ref_dataset.make_dataset(n=600, d=32, n_queries=16, k=10, seed=5)
    graph = ref_vamana.build_vamana(ds.base, R=12, L=24, batch_size=256, seed=5)
    qb = RefQuantizer(32, seed=5).fit_encode(ds.base)
    fields = [{f.name: getattr(o, f.name) for f in dataclasses.fields(o)} for o in (qb, graph)]
    port_qb, port_graph = convert.index_from_reference(*fields)
    return ds, graph, qb, port_graph, port_qb


def _system(tiny, algo="diskann", **kw):
    ds, _, _, graph, qb = tiny
    kw.setdefault("buffer_ratio", 0.2)
    kw.setdefault("n_workers", 2)
    kw.setdefault("batch_size", 4)
    kw.setdefault("params", SearchParams(L=24, W=4))
    return baselines.build_system(algo, ds.base, graph, qb,
                                  baselines.SystemConfig(device="cpu", **kw))


def _proj(results):
    return [(list(r.ids), list(r.dists), r.hops) for r in results]


@pytest.mark.parametrize("fuse", [False, True], ids=["nofuse", "fuse"])
@pytest.mark.parametrize("algo", ALGOS)
def test_rr_parity_with_plan(tiny, algo, fuse):
    ds = tiny[0]
    ref_res, ref = _system(tiny, algo=algo, fuse=fuse).run(ds.queries)
    res, stats = _system(tiny, algo=algo, fuse=fuse, scheduler="rr").run(
        ds.queries, sla=SlaPlan.build(len(ds.queries), sla_ms=5.0))
    assert _proj(res) == _proj(ref_res)
    assert stats.makespan_s == ref.makespan_s
    assert stats.coroutine_switches == ref.coroutine_switches
    assert stats.service_times == ref.latencies
    assert stats.deadline_hits + stats.deadline_misses == len(ds.queries)


@pytest.mark.parametrize("fuse", [False, True], ids=["nofuse", "fuse"])
def test_sla_equal_deadlines_matches_rr_bitwise(tiny, fuse):
    ds = tiny[0]
    n = len(ds.queries)
    rr_res, rr = _system(tiny, fuse=fuse, scheduler="rr").run(
        ds.queries, sla=SlaPlan.build(n, sla_ms=5.0))
    sla_res, sla = _system(tiny, fuse=fuse, scheduler="sla").run(
        ds.queries, sla=SlaPlan.build(n, sla_ms=5.0))
    assert _proj(sla_res) == _proj(rr_res)
    assert sla.makespan_s == rr.makespan_s
    assert sla.coroutine_switches == rr.coroutine_switches
    assert sla.latency_qids == rr.latency_qids


def test_latency_includes_queue_wait(tiny):
    ds = tiny[0]
    ref_res, ref = _system(tiny).run(ds.queries)
    res, stats = _system(tiny).run(ds.queries, sla=SlaPlan.build(len(ds.queries)))
    assert _proj(res) == _proj(ref_res)
    assert stats.makespan_s == ref.makespan_s
    assert stats.service_times == ref.latencies
    assert stats.queue_wait_s > 0.0
    assert max(stats.latencies) > max(stats.service_times)


def test_sla_holds_cold_tenant_floor_rr_violates(tiny):
    """The starvation regression (tests/test_scheduling.py): a zipfian
    4-tenant mix whose cold tenant carries a 1.5 ms SLA.  rr starves it,
    EDF holds its floor without starving the hot tenant — and every
    deadline hit rate is the reference plane's."""
    ds, rgraph, rqb, graph, qb = tiny
    params = SearchParams(L=24, W=4)
    specs = [TenantSpec.from_dataset(f"t{i}", ds, graph, qb, params=params) for i in range(4)]
    ref_specs = [ref_serving.TenantSpec.from_dataset(f"t{i}", ds, rgraph, rqb, params=params)
                 for i in range(4)]
    wl = workload_mod.zipfian_mix([16] * 4, 200, s=1.6, seed=2, qps=30000.0)
    ref_wl = ref_workload.zipfian_mix([16] * 4, 200, s=1.6, seed=2, qps=30000.0)
    assert wl.counts()[3] == min(wl.counts())  # tenant 3 IS the cold one

    rates, ref_rates = {}, {}
    for sched in ("rr", "sla"):
        kw = dict(buffer_ratio=0.2, n_workers=2, batch_size=4, fuse=True, fuse_rows=64,
                  scheduler=sched, sla_ms=[6.0, 6.0, 6.0, 1.5])
        run = ServingPlane(specs, baselines.SystemConfig(device="cpu", **kw)).run(wl)
        ref_run = ref_serving.ServingPlane(
            ref_specs, ref_baselines.SystemConfig(distance_backend="batch", **kw)).run(ref_wl)
        for out, r in ((rates, run), (ref_rates, ref_run)):
            out[sched] = {"cold": r.tenants[3].stats.deadline_hit_rate,
                          "hot": r.tenants[0].stats.deadline_hit_rate,
                          "global": r.stats.deadline_hit_rate}
    assert rates["sla"]["cold"] >= 0.8, rates
    assert rates["rr"]["cold"] < 0.3, rates
    assert rates["sla"]["hot"] >= rates["rr"]["hot"] - 0.05, rates
    assert rates["sla"]["global"] >= rates["rr"]["global"], rates
    assert rates == ref_rates


# --------------------------------------------------------- plan construction


def test_sla_plan_build_per_tenant_deadlines():
    tof = np.array([0, 1, 0, 2, 1], dtype=np.int64)
    arr = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    kw = dict(arrivals=arr, sla_ms=[2.0, 4.0, 8.0], tenant_of=tof, n_tenants=3)
    plan = SlaPlan.build(5, **kw)
    np.testing.assert_allclose(plan.deadlines - plan.arrivals,
                               np.array([2e-3, 4e-3, 2e-3, 8e-3, 4e-3]))
    assert plan.deadline(3) == pytest.approx(3.0 + 8e-3)
    want = ref_scheduling.SlaPlan.build(5, **kw)
    assert np.array_equal(plan.deadlines, want.deadlines)
    assert np.array_equal(plan.arrivals, want.arrivals)


def test_sla_plan_build_keeps_cold_tenants():
    tof = np.zeros(4, dtype=np.int64)  # tenant 1 drew nothing
    plan = SlaPlan.build(4, sla_ms=[1.0, 99.0], tenant_of=tof, n_tenants=2)
    np.testing.assert_allclose(plan.deadlines, np.full(4, 1e-3))


def test_sla_plan_no_deadlines():
    plan = SlaPlan.build(3)
    assert plan.deadlines is None and plan.deadline(0) == float("inf")
    plan.on_complete(0, 1.0, 0.5)  # no controller: a no-op


def test_sla_seconds_scalar_and_sequence():
    np.testing.assert_allclose(sla_seconds(2.0, 3), np.full(3, 2e-3))
    np.testing.assert_allclose(sla_seconds([1.0, 10.0], 2), np.array([1e-3, 1e-2]))
    with pytest.raises(AssertionError):
        sla_seconds([1.0, 2.0, 3.0], 2)


# ------------------------------------------------------- feedback controller


EVENTS = [
    (0, 1.0, 0.004), (1, 1.0, 0.001), (0, 1.0, 0.003), (1, 1.0, 0.0005),
    (0, 1.0, 0.005), (1, 1.0, 0.0008), (0, 1.0, 0.0045), (1, 1.0, 0.0002),
]


def test_controller_order_insensitive_and_equal_to_the_reference():
    sla = np.array([0.002, 0.002])
    fwd, rev = SlaController(2, sla), SlaController(2, sla)
    ref = ref_scheduling.SlaController(2, sla)
    for t, td, lat in EVENTS:
        fwd.on_complete(t, td, lat)
        ref.on_complete(t, td, lat)
    for t, td, lat in reversed(EVENTS):
        rev.on_complete(t, td, lat)
    for c in (rev, ref):
        assert fwd.beam_scale(0) == c.beam_scale(0)
        assert fwd.beam_scale(1) == c.beam_scale(1)
        assert fwd.fuse_rows(256) == c.fuse_rows(256)


def test_controller_beam_and_fuse_bounds():
    c = SlaController(1, np.array([0.001]), min_samples=1)
    c.on_complete(0, 0.0, 0.010)
    assert c.beam_scale(0) == pytest.approx(c.min_scale)
    assert c.fuse_rows(256) == max(c.min_fuse_rows, 25)
    assert c.fuse_rows(16) == 16
    p = SearchParams(k=10, L=12)
    assert c.params_for(0, p).L >= p.k
    for _ in range(4):
        c.on_complete(0, 1.0, 0.0001)
    assert c.beam_scale(0) == pytest.approx(c.max_scale)
    assert c.fuse_rows(256) == 256


def test_controller_identity_when_on_target():
    c = SlaController(1, np.array([0.002]), min_samples=1)
    c.on_complete(0, 0.0, 0.002)
    assert c.beam_scale(0) == 1.0
    p = SearchParams(L=24)
    assert c.params_for(0, p) is p
    assert c.fuse_rows(128) == 128


def test_controller_quota_invariant():
    class _Pool:
        n_slots = 100
        tenant_cap = np.array([40, 40], dtype=np.int64)
        tenant_owned = np.array([35, 10], dtype=np.int64)

    pool = _Pool()
    c = SlaController(2, np.array([0.001, 0.001]), pool=pool, min_samples=1)
    c.on_complete(0, 0.0, 0.003)
    assert pool.tenant_cap[0] == 80 and pool.tenant_cap[1] == 40
    pool.tenant_owned[0] = 95
    c.on_complete(0, 1.0, 0.0001)
    assert pool.tenant_cap[0] == 95 and pool.tenant_cap[0] >= pool.tenant_owned[0]
