"""Bounded schedule-permutation explorer (DPOR-lite) for the engine.

The simulated engine is deterministic: workers and completion events are
ordered by simulated time, with fixed tie-breaks (submission order for the
event heap, worker id for equal-clock workers).  Those tie-breaks are the
only scheduling freedom a real thread-per-core runtime would have had at the
same instants — actions at *distinct* simulated times are causally ordered
by the cost model and may never be swapped.  ``SchedulePolicy`` therefore
permutes exactly the ties:

  * equal-time events in the completion heap drain in a seeded-rank order
    instead of submission order (``event_rank``);
  * equal-clock runnable workers (and stall-flush initiators) are picked by
    a seeded worker permutation instead of lowest-wid (``worker_rank``).

Seed 0 is the identity policy — bitwise the unscheduled engine — and every
run counts how many genuine ties it hit (``ties``), so a "nothing differed"
verdict over schedules that never had a choice to make is visible as a
vacuous one.  The policy also records the engine's decision ``trace``
(wait_any tie-break resolutions as ``("wait_any", qid, pid)``; HBM scatter
boundaries as ``("scatter", n)``), which regression tests replay across
seeds.

``explore`` runs one workload factory under a set of seeds and compares the
returned per-query ``(ids, dists, hops)`` triples bitwise against the seed-0
baseline.  ``reads`` is deliberately NOT compared: which coroutine issues
the page read that others coalesce on is schedule-dependent even though the
answer is not.

The system builders take ``device``: None is the process default (the CUDA
card; ``core.distance.set_default_device("cpu")`` or ``device="cpu"`` runs
the kernels' plain PyTorch versions on the CPU).  On the card a (query, row)
distance must not depend on which other queries share its flush, or a
permuted schedule changes an answer; the distance kernels compute each pair
on its own (``binary_ip`` picks its path by the call's shape, and
``kernels.binary_ip.kernel.tensor_core_launches`` counts the calls that
took its tensor-core path, so a run on the card can show how many did).
"""

from __future__ import annotations

import dataclasses

import numpy as np


class SchedulePolicy:
    """Seeded permutation of the engine's scheduling ties.

    Engine contract (see ``Engine.run``): ``event_rank(seq)`` is called once
    per pushed completion event, in ``seq`` order, and becomes the heap's
    secondary key; ``worker_rank(wid)`` keys equal-clock worker picks;
    ``ties`` counts the decisions that genuinely had more than one choice;
    ``note(entry)`` appends a decision to the replayable trace.
    """

    def __init__(self, seed: int, n_workers: int = 64):
        self.seed = int(seed)
        self.ties: dict[str, int] = {"worker": 0, "event": 0, "slack": 0}
        self.trace: list[tuple] = []
        self._rng = None
        self._worker_perm = None
        if self.seed:
            rng = np.random.default_rng(self.seed)
            self._worker_perm = rng.permutation(int(n_workers))
            self._rng = rng

    def event_rank(self, seq: int) -> int:
        if self._rng is None:
            return 0  # identity: heap order degenerates to (time, seq)
        return int(self._rng.integers(0, 1 << 30))

    def worker_rank(self, wid: int) -> int:
        if self._worker_perm is None:
            return wid
        return int(self._worker_perm[wid % len(self._worker_perm)])

    def slack_rank(self, qid: int) -> int:
        """Tie-break key for EQUAL-DEADLINE ready entries under the "sla"
        scheduler — at one instant equal deadlines mean equal slack, a
        genuine scheduling race.  Must be a pure function of qid (NOT a
        sequential rng draw): the same query must rank the same wherever the
        tie shows up, so a seed permutes ties consistently instead of
        injecting order-dependence of its own.  Identity (seed 0) preserves
        the engine's submission-order tie-break."""
        if self._rng is None:
            return 0  # identity: engine falls through to submission order
        # splitmix64-style hash of (seed, qid): stateless, well-mixed
        x = (qid + 0x9E3779B97F4A7C15 * (self.seed + 1)) & ((1 << 64) - 1)
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        return int(x ^ (x >> 31))

    def note(self, entry) -> None:
        self.trace.append(tuple(entry))


def normalize_results(results, include_hops: bool = True) -> tuple:
    """Schedule-independent projection of a result list: per-query
    ``(ids, dists, hops)``, hashable for bitwise comparison.

    ``include_hops=False`` drops the hop count — the comparison for
    cache-ADAPTIVE algorithms (velo's cbs pivot consults residency, and
    residency at a tie instant is legitimately schedule-dependent, so the
    path length may vary even when the answer does not)."""
    out = []
    for r in results:
        proj = (
            tuple(int(v) for v in r.ids),
            tuple(float(d) for d in r.dists),
        )
        if include_hops:
            proj = proj + (int(r.hops),)
        out.append(proj)
    return tuple(out)


def trace_by_query(trace, kind: str = "wait_any") -> dict[int, list[tuple]]:
    """Group a policy's decision trace by query id (entries of one kind).
    Per-query sequences are the replay unit: the GLOBAL interleaving of
    queries legitimately differs across schedules, the decisions within one
    query must not."""
    out: dict[int, list[tuple]] = {}
    for entry in trace:
        if entry[0] == kind:
            out.setdefault(int(entry[1]), []).append(entry)
    return out


def scatter_sizes(trace) -> list[int]:
    """The HBM staged-scatter boundary sizes, in boundary order."""
    return [int(entry[1]) for entry in trace if entry[0] == "scatter"]


@dataclasses.dataclass
class ScheduleReport:
    seed: int
    ties: dict[str, int]
    equal: bool                # results bitwise equal to the seed-0 baseline
    first_diff: str | None
    trace: list[tuple]


def explore(run_under, seeds, include_hops: bool = True) -> list[ScheduleReport]:
    """Run ``run_under(policy) -> results`` under seed 0 (the identity
    baseline) and then every seed in ``seeds``; report bitwise equality of
    the normalized results against the baseline.  The factory must build a
    FRESH system per call — pools and caches are stateful across runs."""
    base_policy = SchedulePolicy(0)
    baseline = normalize_results(run_under(base_policy), include_hops)
    reports = [ScheduleReport(0, dict(base_policy.ties), True, None,
                              base_policy.trace)]
    for seed in seeds:
        policy = SchedulePolicy(int(seed))
        res = normalize_results(run_under(policy), include_hops)
        equal = res == baseline
        first_diff = None
        if not equal:
            for qid, (a, b) in enumerate(zip(baseline, res)):
                if a != b:
                    first_diff = (
                        f"query {qid}: {a[:2]}... (seed 0) vs "
                        f"{b[:2]}... (seed {seed})"
                    )
                    break
            if first_diff is None:
                first_diff = "result lists differ in length"
        reports.append(ScheduleReport(int(seed), dict(policy.ties), equal,
                                      first_diff, policy.trace))
    return reports


# --------------------------------------------------------------- smoke rig


def _smoke_fixture(n: int = 600, d: int = 32, n_queries: int = 24,
                   seed: int = 0):
    """One small clustered dataset + graph + quantizer, built once per
    process (graph construction dominates the smoke runtime)."""
    global _FIXTURE
    key = (n, d, n_queries, seed)
    if _FIXTURE is not None and _FIXTURE[0] == key:
        return _FIXTURE[1]
    from repro_torch.core.dataset import make_dataset
    from repro_torch.core.quant import RabitQuantizer
    from repro_torch.core.vamana import build_vamana

    ds = make_dataset(n=n, d=d, n_queries=n_queries, k=5, seed=seed)
    graph = build_vamana(ds.base, R=12, L=24, batch_size=128, seed=seed)
    qb = RabitQuantizer(ds.dim, seed=seed).fit_encode(ds.base)
    _FIXTURE = (key, (ds, graph, qb))
    return ds, graph, qb


_FIXTURE = None


def run_system_under(policy, name: str, *, n_workers: int = 2,
                     batch_size: int = 4, buffer_ratio: float = 0.3,
                     hbm_tier: bool = False, verify: bool = True,
                     fixture=None, device=None, **config_kw):
    """Build a FRESH system on the torch engine on ``device`` and run the
    smoke workload under ``policy``.  ``verify`` arms the dynamic protocol
    checker alongside the exploration, so every explored interleaving is
    also transition-checked."""
    import dataclasses as _dc

    from repro_torch.core.baselines import SystemConfig, build_system

    ds, graph, qb = fixture if fixture is not None else _smoke_fixture()
    cfg = SystemConfig(
        n_workers=n_workers, batch_size=batch_size,
        buffer_ratio=buffer_ratio, hbm_tier=hbm_tier,
        verify_protocol=verify, device=device,
    )
    if config_kw:
        cfg = _dc.replace(cfg, **config_kw)
    system = build_system(name, ds.base, graph, qb, config=cfg)
    results, _stats = system.run(ds.queries, schedule=policy)
    return results


def run_sla_under(policy, *, n_workers: int = 2, batch_size: int = 4,
                  n_ops: int = 36, qps: float = 2500.0, sla_ms: float = 2.0,
                  fixture=None, device=None):
    """Build a FRESH 3-tenant serving plane in "sla" mode (pure EDF:
    feedback controller OFF) and run a bursty arrival mix under ``policy``.

    Burst-clustered arrivals land whole same-tenant runs at one instant, so
    their deadlines tie exactly — the equal-slack races ``slack_rank``
    permutes.  The controller stays off here for the same reason velo's cbs
    pivot does in ``smoke``: its steering is input-adaptive with respect to
    completion timing BY DESIGN (a different interleaving legitimately
    shifts the windowed tail signal and with it beam widths), so the bitwise
    claim covers the deterministic EDF scheduler; the feedback loop is
    exercised by the serving plane's own tests instead."""
    from repro_torch.core.baselines import SystemConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.serving import ServingPlane, TenantSpec
    from repro_torch.core.workload import bursty_mix

    ds, graph, qb = fixture if fixture is not None else _smoke_fixture()
    specs = [
        TenantSpec.from_dataset(
            f"t{i}", ds, graph, qb, params=SearchParams(cbs=False)
        )
        for i in range(3)
    ]
    cfg = SystemConfig(
        n_workers=n_workers, batch_size=batch_size, buffer_ratio=0.3,
        scheduler="sla", sla_ms=sla_ms, sla_feedback=False,
        verify_protocol=True, device=device,
    )
    plane = ServingPlane(specs, cfg)
    wl = bursty_mix(
        [len(ds.queries)] * 3, n_ops, mean_burst=6, s=1.2, seed=3, qps=qps
    )
    return plane.run(wl, schedule=policy).results


def smoke_sla(n_schedules: int = 5, base_seed: int = 1, device=None):
    """The ``--explore`` leg for the SLA scheduler: the pure-EDF serving
    plane under permuted schedules must be bitwise schedule-invariant, WITH
    equal-slack ties genuinely permuted (the slack tie count in the report
    shows the pass was not vacuous)."""
    seeds = [base_seed + i for i in range(n_schedules)]

    def run_under(policy):
        return run_sla_under(policy, device=device)

    return {"sla-edf": explore(run_under, seeds)}


def smoke(algorithms=("velo", "diskann", "starling", "pipeann", "inmemory"),
          n_schedules: int = 5, base_seed: int = 1,
          hbm_for=("velo",), verify: bool = True, device=None):
    """The CLI's ``--explore`` entry: every algorithm under ``n_schedules``
    permuted schedules (seeds ``base_seed .. base_seed+n-1``), protocol
    checker armed.  Returns ``{algorithm: [ScheduleReport, ...]}``.

    The velo systems run with the cache-aware pivot DISABLED here: cbs is
    input-adaptive with respect to residency timing (Alg. 2 pivots on
    ``InMemory()``), so its search path — and under enough pressure its
    answer — legitimately varies across interleavings.  That adaptivity is
    exercised by the dynamic checker instead; the bitwise claim covers the
    deterministic access paths of all five algorithms."""
    import dataclasses as _dc

    from repro_torch.core.search import SearchParams

    seeds = [base_seed + i for i in range(n_schedules)]
    out: dict[str, list[ScheduleReport]] = {}
    for name in algorithms:
        kw = {}
        if name in ("velo", "velo-page", "+cbs"):
            kw["params"] = SearchParams(cbs=False)
        hbm = name in hbm_for

        def run_under(policy, _name=name, _hbm=hbm, _kw=kw):
            return run_system_under(policy, _name, hbm_tier=_hbm,
                                    verify=verify, device=device, **_kw)

        out[name] = explore(run_under, seeds)
    return out
