"""The port's schedule explorer (repro_torch.analysis.explore) against the
JAX package's, on the CPU.

  * ``SchedulePolicy`` gives the reference's rank streams seed for seed (both
    draw from numpy), and seed 0 is the identity;
  * seed 0 is bitwise the unscheduled engine, and ``smoke()`` gives the
    reference's per-query results (the reference on its ``pallas`` backend,
    as in ``test_torch_system.py::test_velo_matches_reference_pallas``) with
    the same tie counts, schedule by schedule;
  * the two regression replays over 50 permuted interleavings: pipeann's
    wait_any tie-break decisions replay per query, and velo's HBM
    staged-scatter boundary is deterministic under a fixed seed while the
    results stay schedule-invariant; and the pure-EDF serving plane is
    schedule-invariant with equal-slack ties permuted.
"""

import numpy as np
import pytest
import torch

from repro.analysis import explore as ref_explore
from repro.core.search import SearchParams as RefSearchParams
from repro_torch.analysis.explore import (
    SchedulePolicy,
    _smoke_fixture,
    explore,
    normalize_results,
    run_sla_under,
    run_system_under,
    scatter_sizes,
    smoke,
    smoke_sla,
    trace_by_query,
)
from repro_torch.core import baselines
from repro_torch.core.search import SearchParams

ALGOS = ("velo", "diskann", "starling", "pipeann", "inmemory")
N_SCHEDULES = 50


@pytest.fixture(scope="module")
def small():
    torch.set_num_threads(1)
    return _smoke_fixture()


def _norm(results):
    return normalize_results(results)


def test_fixture_is_the_reference_fixture(small):
    ds, graph, qb = small
    rds, rgraph, rqb = ref_explore._smoke_fixture()
    np.testing.assert_array_equal(ds.base, rds.base)
    np.testing.assert_array_equal(ds.queries, rds.queries)
    np.testing.assert_array_equal(graph.adjacency, rgraph.adjacency)
    assert graph.medoid == rgraph.medoid
    np.testing.assert_array_equal(qb.binary_codes, rqb.binary_codes)
    np.testing.assert_array_equal(qb.ext_codes, rqb.ext_codes)


# ============================================== schedule explorer contracts


def test_seed0_policy_is_identity():
    pol = SchedulePolicy(0)
    assert [pol.event_rank(s) for s in range(5)] == [0] * 5
    assert [pol.worker_rank(w) for w in range(8)] == list(range(8))
    assert [pol.slack_rank(q) for q in range(5)] == [0] * 5
    pol.note(("wait_any", 3, 7))
    assert pol.trace == [("wait_any", 3, 7)]


def test_seeded_policy_permutes_and_is_reproducible():
    a, b = SchedulePolicy(11), SchedulePolicy(11)
    ranks_a = [a.event_rank(s) for s in range(64)]
    ranks_b = [b.event_rank(s) for s in range(64)]
    assert ranks_a == ranks_b
    assert len(set(ranks_a)) > 1
    assert [a.worker_rank(w) for w in range(8)] != list(range(8)) or \
           [a.worker_rank(w) for w in range(8, 16)] != list(range(8, 16))


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 23, 50])
def test_policy_streams_equal_the_reference(seed):
    """Seed for seed, the port's policy ranks events, workers and slack ties
    exactly as the reference's, interleaved as an engine calls them."""
    mine, ref = SchedulePolicy(seed, n_workers=8), ref_explore.SchedulePolicy(seed, n_workers=8)
    for step in range(200):
        assert mine.event_rank(step) == ref.event_rank(step)
        assert mine.worker_rank(step) == ref.worker_rank(step)
        assert mine.slack_rank(step * 7919) == ref.slack_rank(step * 7919)


def test_seed0_schedule_is_bitwise_the_unscheduled_engine(small):
    ds, graph, qb = small
    cfg = baselines.SystemConfig(n_workers=2, batch_size=4, buffer_ratio=0.3,
                                 device="cpu", verify_protocol=True)
    ref, _ = baselines.build_system("velo", ds.base, graph, qb, config=cfg).run(ds.queries)
    got = run_system_under(SchedulePolicy(0), "velo", fixture=small, device="cpu")
    assert _norm(got) == _norm(ref)


def test_trace_helpers():
    trace = [("wait_any", 1, 5), ("scatter", 3), ("wait_any", 0, 2),
             ("wait_any", 1, 6), ("scatter", 8)]
    assert trace_by_query(trace) == {
        1: [("wait_any", 1, 5), ("wait_any", 1, 6)],
        0: [("wait_any", 0, 2)],
    }
    assert scatter_sizes(trace) == [3, 8]


def test_normalize_results_hops_flag():
    class R:
        ids = [np.int64(3)]
        dists = [np.float32(0.5)]
        hops = 7
    assert normalize_results([R()]) == (((3,), (0.5,), 7),)
    assert normalize_results([R()], include_hops=False) == (((3,), (0.5,)),)


def test_smoke_reports_invariant_and_nonvacuous(small):
    reports = smoke(algorithms=("diskann",), n_schedules=2, hbm_for=(), device="cpu")
    reps = reports["diskann"]
    assert len(reps) == 3  # baseline + 2 seeds
    assert all(r.equal for r in reps)
    assert sum(r.ties["event"] + r.ties["worker"] for r in reps[1:]) > 0


def test_builders_default_to_the_card(small, monkeypatch):
    """With no device given the explorer's systems ask for the CUDA card, and
    without one they raise instead of running on the CPU."""
    from repro_torch.core import distance

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distance.default_device() == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_system_under(SchedulePolicy(0), "velo", fixture=small)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sla_under(SchedulePolicy(0), fixture=small)


def _ref_run_under(algo, seen):
    """The reference's smoke leg for ``algo`` on its pallas backend, keeping
    each run's results in ``seen``."""
    kw = {"params": RefSearchParams(cbs=False)} if algo == "velo" else {}

    def run_under(policy):
        res = ref_explore.run_system_under(policy, algo, hbm_tier=algo == "velo",
                                           distance_backend="pallas", **kw)
        seen.append(res)
        return res

    return run_under


@pytest.mark.parametrize("algo", ALGOS)
def test_smoke_matches_the_reference(algo, small):
    """``smoke()`` on the CPU: every schedule of every algorithm hits the
    reference's tie counts and is invariant; its per-query results are the
    reference's (ids and hops exact, dists within float tolerance)."""
    pytest.importorskip("jax")
    mine = smoke(algorithms=(algo,), n_schedules=2, device="cpu")[algo]
    seen = []
    ref = ref_explore.explore(_ref_run_under(algo, seen), [1, 2])
    assert [r.ties for r in mine] == [r.ties for r in ref]
    assert all(r.equal for r in mine) and all(r.equal for r in ref)
    assert [r.trace for r in mine] == [r.trace for r in ref]
    assert sum(r.ties["event"] + r.ties["worker"] for r in mine[1:]) > 0
    kw = {"params": SearchParams(cbs=False)} if algo == "velo" else {}
    got = run_system_under(SchedulePolicy(0), algo, hbm_tier=algo == "velo",
                           fixture=small, device="cpu", **kw)
    want = seen[0]
    assert len(got) == len(want)
    for i, (r0, r1) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(r0.ids, r1.ids, err_msg=f"{algo} query {i}")
        assert r0.hops == r1.hops, f"{algo} query {i}"
        np.testing.assert_allclose(r0.dists, r1.dists, rtol=2e-3, atol=2e-3,
                                   err_msg=f"{algo} query {i}")


def test_smoke_sla_matches_the_reference(small):
    mine = smoke_sla(n_schedules=2, device="cpu")["sla-edf"]
    ref = ref_explore.smoke_sla(n_schedules=2)["sla-edf"]
    assert [r.ties for r in mine] == [r.ties for r in ref]
    assert all(r.equal for r in mine)
    assert sum(r.ties["slack"] for r in mine[1:]) > 0


# ------------------------- regressions: >= 50 explored interleavings


def test_pipeann_wait_any_replays_across_50_interleavings(small):
    """pipeann's multi-submit wait_any tie-break: across 50 permuted schedules
    the results are bitwise invariant AND each query's sequence of wait_any
    resolutions replays identically."""
    def run_under(policy):
        return run_system_under(policy, "pipeann", verify=False, fixture=small,
                                device="cpu")

    reports = explore(run_under, range(1, N_SCHEDULES + 1))
    assert all(r.equal for r in reports), \
        [r.first_diff for r in reports if not r.equal]
    assert sum(r.ties["worker"] + r.ties["event"] for r in reports[1:]) > 0
    base = trace_by_query(reports[0].trace)
    assert base
    for r in reports[1:]:
        assert trace_by_query(r.trace) == base, f"seed {r.seed} diverged"


def test_velo_hbm_scatter_invariant_across_50_interleavings(small):
    """The HBM staged-scatter boundary: results bitwise invariant across 50
    interleavings (cbs off), and the scatter boundary sequence deterministic
    under a FIXED seed."""
    def run_under(policy):
        return run_system_under(policy, "velo", hbm_tier=True, verify=False,
                                params=SearchParams(cbs=False), fixture=small,
                                device="cpu")

    reports = explore(run_under, range(1, N_SCHEDULES + 1))
    assert all(r.equal for r in reports), \
        [r.first_diff for r in reports if not r.equal]
    assert sum(r.ties["worker"] + r.ties["event"] for r in reports[1:]) > 0
    assert sum(len(scatter_sizes(r.trace)) for r in reports) > 0
    for seed in (0, 7, 23):
        p1, p2 = SchedulePolicy(seed), SchedulePolicy(seed)
        run_under(p1)
        run_under(p2)
        assert p1.trace == p2.trace, f"seed {seed}: trace not deterministic"
        assert scatter_sizes(p1.trace) == scatter_sizes(p2.trace)


def test_velo_fused_invariant_across_50_interleavings(small):
    """Fused multi-query scoring on the CPU: a schedule changes which queries
    share each (B, N) call, and the plain distance versions reduce each
    (query, row) pair on its own, so ids, dists and hops stay bitwise
    invariant across 50 interleavings (cbs off, as in the HBM replay)."""
    def run_under(policy):
        return run_system_under(policy, "velo", verify=False, fuse=True,
                                params=SearchParams(cbs=False), fixture=small,
                                device="cpu")

    reports = explore(run_under, range(1, N_SCHEDULES + 1))
    assert all(r.equal for r in reports), \
        [r.first_diff for r in reports if not r.equal]
    assert sum(r.ties["worker"] + r.ties["event"] for r in reports[1:]) > 0


def test_sla_edf_schedule_invariant_with_slack_ties(small):
    def run_under(policy):
        return run_sla_under(policy, fixture=small, device="cpu")

    reports = explore(run_under, [7, 8])
    assert all(r.equal for r in reports), \
        [r.first_diff for r in reports if not r.equal]
    assert sum(r.ties["slack"] for r in reports[1:]) > 0


def test_cli_explore_on_the_cpu(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--explore", "--device", "cpu", "--schedules", "1",
                 "--algorithms", "diskann"]) == 0
    out = capsys.readouterr().out
    assert "diskann: 1 schedule(s) explored" in out
    assert "sla-edf: 1 schedule(s) explored" in out
    assert "MISMATCH" not in out
