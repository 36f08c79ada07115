"""SLA-aware scheduling plane: arrival times, deadlines, and the feedback
controller that steers the engine online.

The engine's coroutine runtime (core.engine) is cooperative: workers pick
the next ready coroutine and run it until it yields.  *Which* ready
coroutine runs next is the scheduling policy:

  * ``scheduler="rr"`` (the default) is plain FIFO round-robin — bitwise
    identical to the pre-SLA engine for every algorithm and topology (the
    parity contract every test in this repo leans on);
  * ``scheduler="sla"`` picks by deadline slack, EDF-style: each query
    carries an absolute arrival time and an absolute deadline
    (``arrival + sla``), and both query admission and the per-worker ready
    queue choose the earliest-deadline entry first.  Slack ordering at a
    fixed instant is deadline ordering, so the pick key is simply the
    deadline; equal-deadline ties break by submission order (and are a
    genuine scheduling race the explorer permutes — see
    ``analysis.explore.SchedulePolicy.slack_rank``).

Arrival times additionally fix a latency-accounting defect: the engine used
to measure latency from worker *dispatch* (``start_time[qid]``), so queue
wait — the dominant term of tail latency under burst — never reached
``p99_latency_ms``.  With an ``SlaPlan`` attached, ``latencies`` measure
completion minus ARRIVAL; the old dispatch-relative number is kept as
``WorkloadStats.service_times`` / ``service_time_s``.  Without a plan the
engine behaves exactly as before (latency == service time, queue wait 0).

``SlaController`` is the feedback loop:
completions stream into per-tenant sliding windows, and every steering
output is a PURE FUNCTION of the window *content* —

  * per-tenant beam scale: a tenant whose windowed tail latency drifts past
    its SLA gets its candidate-list width L shrunk (cheaper, slightly less
    accurate queries that drain the backlog); a tenant with slack widens
    back up to ``max_scale`` (recovering — or banking — recall);
  * global fuse budget: under system-wide pressure the rendezvous flush
    budget ``fuse_rows`` shrinks (earlier flushes, lower batching latency),
    and relaxes back when the tail recovers;
  * tenant quota: a deadline-missing tenant's soft slot cap on the shared
    buffer pool is raised (more cache -> shorter service times), tenants
    with slack fall back toward their base cap.

Pure-function steering matters for verification: the explorer permutes
equal-time scheduling ties, and a controller whose state depended on the
ORDER of equal-time completions would make ``sla`` runs schedule-variant.
Windows are multisets pruned by time, decisions are computed from sorted
window content, so any permutation of equal-time updates lands in the same
state.  (The controller is still input-adaptive with respect to timing *by
design* — like velo's cache-aware pivot, exploration covers the pure-EDF
scheduler and the feedback loop is exercised by the benchmarks; see
docs/scheduling.md.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

SCHEDULERS = ("rr", "sla")


def sla_seconds(sla_ms, n_tenants: int) -> np.ndarray:
    """Normalize ``SystemConfig.sla_ms`` (scalar or per-tenant sequence of
    milliseconds) into a per-tenant array of SECONDS."""
    if np.isscalar(sla_ms):
        return np.full(n_tenants, float(sla_ms) / 1e3)
    out = np.asarray(sla_ms, dtype=np.float64) / 1e3
    assert out.shape == (n_tenants,), (
        f"sla_ms has {out.shape[0]} entries for {n_tenants} tenants"
    )
    return out


class SlaController:
    """Online feedback from completion latencies to beam width, fuse budget
    and tenant quota.  Every output is a pure function of the per-tenant
    completion windows, so equal-time updates commute (see module doc).

    ``ratio(t)`` is the steering signal: the ``target_quantile`` of
    latency/SLA over tenant t's window (1.0 == the tail exactly meets the
    deadline).  Beam scale is ``clip(ratio ** -damp)`` — a tenant running
    its tail at 2x the SLA searches with a ~0.6x beam until it recovers.
    """

    def __init__(
        self,
        n_tenants: int,
        sla_s: np.ndarray,
        horizon_factor: float = 8.0,
        min_scale: float = 0.7,
        max_scale: float = 1.25,
        damp: float = 0.5,
        target_quantile: float = 0.9,
        min_samples: int = 4,
        min_fuse_rows: int = 32,
        pool=None,
        quota_boost: float = 2.0,
    ):
        assert n_tenants >= 1
        self.n_tenants = int(n_tenants)
        self.sla_s = np.asarray(sla_s, dtype=np.float64)
        assert self.sla_s.shape == (self.n_tenants,)
        self.horizon_s = float(horizon_factor) * float(self.sla_s.max())
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.damp = float(damp)
        self.q = float(target_quantile)
        self.min_samples = int(min_samples)
        self.min_fuse_rows = int(min_fuse_rows)
        # per-tenant completion windows: lists of (t_done, latency/sla)
        self._window: list[list[tuple[float, float]]] = [
            [] for _ in range(self.n_tenants)
        ]
        self._scale = np.ones(self.n_tenants, dtype=np.float64)
        self._global_ratio = 0.0
        self.completions = 0
        self.adjustments = 0          # steering updates that moved a scale
        # optional shared-pool quota steering (serving plane only)
        self._pool = None
        self._base_cap = None
        self.quota_boost = float(quota_boost)
        if pool is not None and getattr(pool, "tenant_cap", None) is not None:
            self._pool = pool
            self._base_cap = pool.tenant_cap.copy()

    # ------------------------------------------------------------- updates

    def on_complete(self, tenant: int, t_done: float, latency_s: float) -> None:
        """Fold one completion into tenant's window and re-derive every
        steering output from window content (order-insensitive for
        equal-``t_done`` updates)."""
        t = int(tenant)
        sla = self.sla_s[t]
        self._window[t].append((float(t_done), float(latency_s) / sla))
        self.completions += 1
        lo = float(t_done) - self.horizon_s
        for win in self._window:
            while win and win[0][0] < lo:
                win.pop(0)
        self._recompute()

    def _ratio(self, t: int) -> float:
        """Windowed tail signal for tenant t: the target quantile of
        latency/SLA (0.0 until the window has ``min_samples`` entries)."""
        win = self._window[t]
        if len(win) < self.min_samples:
            return 0.0
        vals = sorted(r for _, r in win)
        rank = min(len(vals) - 1, int(self.q * len(vals)))
        return vals[rank]

    def _recompute(self) -> None:
        ratios = np.array([self._ratio(t) for t in range(self.n_tenants)])
        new = np.ones(self.n_tenants, dtype=np.float64)
        active = ratios > 0.0
        new[active] = np.clip(
            ratios[active] ** -self.damp, self.min_scale, self.max_scale
        )
        if not np.array_equal(new, self._scale):
            self.adjustments += 1
        self._scale = new
        self._global_ratio = float(ratios.max()) if len(ratios) else 0.0
        if self._pool is not None:
            self._apply_quota(ratios)

    def _apply_quota(self, ratios: np.ndarray) -> None:
        """Raise a deadline-missing tenant's soft slot cap (up to
        ``quota_boost`` x its base cap, clamped to the pool) and relax
        on-target tenants back to base.  Caps never drop below the tenant's
        CURRENT ownership — the pool's quota invariant
        (``tenant_owned <= tenant_cap``) must hold at every flush check."""
        pool = self._pool
        n = min(self.n_tenants, len(self._base_cap))
        for t in range(n):
            boost = float(np.clip(ratios[t], 1.0, self.quota_boost))
            cap = min(int(round(self._base_cap[t] * boost)), pool.n_slots)
            pool.tenant_cap[t] = max(cap, int(pool.tenant_owned[t]))

    # ------------------------------------------------------------- outputs

    def beam_scale(self, tenant: int) -> float:
        return float(self._scale[int(tenant)])

    def params_for(self, tenant: int, params):
        """``SearchParams`` with the candidate-list width L steered by the
        tenant's current beam scale (never below k)."""
        scale = self.beam_scale(tenant)
        if scale == 1.0:
            return params
        L = max(int(params.k), int(round(params.L * scale)))
        if L == params.L:
            return params
        return dataclasses.replace(params, L=L)

    def fuse_rows(self, base_rows: int) -> int:
        """The rendezvous flush budget under the current global tail
        pressure: shrinks proportionally past the deadline, never below
        ``min_fuse_rows`` (or the base, whichever is smaller)."""
        r = self._global_ratio
        if r <= 1.0:
            return base_rows
        floor = min(self.min_fuse_rows, base_rows)
        return max(floor, int(base_rows / r))


@dataclasses.dataclass
class SlaPlan:
    """Per-run arrival/deadline schedule handed to ``Engine.run``.

    ``arrivals`` are absolute seconds on the simulated clock (a query cannot
    be admitted before it arrives; latency is measured FROM here).
    ``deadlines`` are absolute seconds (``arrival + sla``); None disables
    deadline accounting and EDF ordering degenerates to FIFO.  ``tenant_of``
    maps qid -> tenant for the controller (None == single tenant)."""

    arrivals: np.ndarray
    deadlines: np.ndarray | None = None
    tenant_of: np.ndarray | None = None
    controller: SlaController | None = None

    def __post_init__(self):
        self.arrivals = np.asarray(self.arrivals, dtype=np.float64)
        if self.deadlines is not None:
            self.deadlines = np.asarray(self.deadlines, dtype=np.float64)
            assert self.deadlines.shape == self.arrivals.shape

    @classmethod
    def build(
        cls,
        n_queries: int,
        arrivals=None,
        sla_ms=None,
        tenant_of=None,
        n_tenants=None,
        controller=None,
    ) -> "SlaPlan":
        """Assemble a plan from workload pieces: missing arrivals mean an
        open-loop batch (everything arrives at t=0 and latency == queue
        wait + service); ``sla_ms`` (scalar or per-tenant) sets deadlines.
        ``n_tenants`` carries the TRUE tenant count — deriving it from the
        observed max drops cold tenants, the exact bug workload.n_tenants
        exists to prevent."""
        arr = (
            np.zeros(n_queries, dtype=np.float64)
            if arrivals is None else np.asarray(arrivals, dtype=np.float64)
        )
        assert arr.shape == (n_queries,)
        deadlines = None
        if sla_ms is not None:
            tof = (
                np.zeros(n_queries, dtype=np.int64)
                if tenant_of is None
                else np.asarray(tenant_of, dtype=np.int64)
            )
            if n_tenants is None:
                n_tenants = int(tof.max()) + 1 if n_queries else 1
            deadlines = arr + sla_seconds(sla_ms, n_tenants)[tof]
        return cls(
            arrivals=arr,
            deadlines=deadlines,
            tenant_of=(
                None if tenant_of is None
                else np.asarray(tenant_of, dtype=np.int64)
            ),
            controller=controller,
        )

    def deadline(self, qid: int) -> float:
        if self.deadlines is None:
            return float("inf")
        return float(self.deadlines[qid])

    def on_complete(self, qid: int, t_done: float, latency_s: float) -> None:
        if self.controller is None:
            return
        tenant = 0 if self.tenant_of is None else int(self.tenant_of[qid])
        self.controller.on_complete(tenant, t_done, latency_s)
