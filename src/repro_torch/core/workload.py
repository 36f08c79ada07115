"""Mixed-traffic workload generators for the multi-tenant serving plane.

A production serving system never sees one index's queries in isolation: N
tenants share the engine and the buffer pool, and WHICH tenant each arriving
query belongs to is itself a distribution.  Cache policy under mixed/skewed
traffic is where disk-resident systems win or lose (the I/O design-space
literature's recurring result), so the arrival mix is modeled explicitly:

  * ``uniform_mix``  — arrivals spread evenly across tenants (round-robin-ish
    random; the fair-share baseline);
  * ``zipfian_mix``  — tenant popularity follows a Zipf law: one hot tenant
    dominates the stream (the skew regime where a shared pool should beat a
    static partition);
  * ``bursty_mix``   — arrivals come in bursts: a geometric run length keeps
    each tenant's queries temporally clustered (locality a clock cache can
    exploit, and the worst case for a static partition's idle shards).

Every generator returns a ``MixedWorkload`` — parallel arrays of (tenant id,
per-tenant query index) in arrival order.  Query indices are assigned
*sequentially per tenant* (each arrival consumes the tenant's next unused
query, wrapping around its query set): tenant t's queries are processed in
exactly the order an isolated single-tenant run would process them, which is
what makes the serving plane's isolation-contract parity tests possible.

Generators are pure functions of their seed — the same workload replays
bit-identically across runs and processes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _zipf_probs(n_tenants: int, s: float) -> np.ndarray:
    """Tenant-popularity law shared by the skewed generators: rank^-s,
    normalized (rank 1 — tenant 0 — is the hot tenant)."""
    ranks = np.arange(1, n_tenants + 1, dtype=np.float64)
    probs = ranks ** (-s)
    return probs / probs.sum()


@dataclasses.dataclass(frozen=True)
class MixedWorkload:
    """A multi-tenant arrival sequence: per-arrival tenant + query index."""

    name: str
    tenant_ids: np.ndarray   # (m,) int64 — tenant of each arriving query
    query_ids: np.ndarray    # (m,) int64 — index into that tenant's query set
    # True tenant count, carried from the generator.  Deriving it from
    # ``tenant_ids.max()+1`` silently drops cold tenants that drew zero
    # arrivals (heavy zipf s, short streams) and skews per-tenant accounting.
    n_tenants: int = 0
    # Absolute arrival time of each query in simulated seconds (None == the
    # open-loop batch regime: everything arrives at t=0, latency == queue
    # wait + service).  Generators attach these when given a ``qps`` rate;
    # the serving plane threads them into per-query deadlines (SlaPlan).
    arrival_s: np.ndarray | None = None

    def __post_init__(self):
        assert self.tenant_ids.shape == self.query_ids.shape
        if self.arrival_s is not None:
            object.__setattr__(
                self, "arrival_s",
                np.asarray(self.arrival_s, dtype=np.float64),
            )
            assert self.arrival_s.shape == self.tenant_ids.shape
        if self.n_tenants == 0 and len(self):
            # Back-compat for hand-built workloads: fall back to the observed
            # maximum (the old, lossy derivation) only when no count is given.
            object.__setattr__(
                self, "n_tenants", int(self.tenant_ids.max()) + 1
            )
        if len(self):
            assert int(self.tenant_ids.max()) < self.n_tenants

    def __len__(self) -> int:
        return int(self.tenant_ids.shape[0])

    def counts(self) -> np.ndarray:
        """Arrivals per tenant."""
        return np.bincount(self.tenant_ids, minlength=self.n_tenants)

    def positions(self, tenant: int) -> np.ndarray:
        """Global arrival positions of one tenant's queries, in order."""
        return np.flatnonzero(self.tenant_ids == tenant)

    def run_lengths(self) -> list[int]:
        """Lengths of the maximal same-tenant runs (burstiness diagnostic)."""
        if not len(self):
            return []
        change = np.flatnonzero(np.diff(self.tenant_ids) != 0)
        edges = np.concatenate([[-1], change, [len(self) - 1]])
        return list(np.diff(edges))


def _poisson_arrivals(rng, n_ops: int, qps: float) -> np.ndarray:
    """Open-arrival Poisson process at rate ``qps``: exponential
    inter-arrival gaps, cumulative absolute times."""
    assert qps > 0
    return np.cumsum(rng.exponential(1.0 / qps, size=n_ops))


def _burst_arrivals(rng, tenants: np.ndarray, qps: float) -> np.ndarray:
    """Burst-clustered arrivals matching the tenant runs: every query of a
    same-tenant run arrives AT the run's start instant (the worst case for
    queue wait — and a source of genuinely equal deadlines the schedule
    explorer can permute); run starts are spaced exponentially so the
    long-run rate is still ``qps``."""
    assert qps > 0
    n = len(tenants)
    out = np.empty(n, dtype=np.float64)
    if n == 0:
        return out
    change = np.flatnonzero(np.diff(tenants) != 0)
    starts = np.concatenate([[0], change + 1])
    lengths = np.diff(np.concatenate([starts, [n]]))
    t = 0.0
    for s0, ln in zip(starts, lengths):
        t += rng.exponential(ln / qps)
        out[s0 : s0 + ln] = t
    return out


def _sequential_query_ids(
    tenant_ids: np.ndarray, queries_per_tenant
) -> np.ndarray:
    """Each arrival consumes its tenant's next query, wrapping at the end of
    the tenant's query set — per-tenant order matches an isolated run."""
    queries_per_tenant = np.asarray(queries_per_tenant, dtype=np.int64)
    next_q = np.zeros(queries_per_tenant.shape[0], dtype=np.int64)
    out = np.empty(len(tenant_ids), dtype=np.int64)
    for i, t in enumerate(tenant_ids):
        out[i] = next_q[t] % queries_per_tenant[t]
        next_q[t] += 1
    return out


def uniform_mix(
    queries_per_tenant, n_ops: int, seed: int = 0, qps: float | None = None
) -> MixedWorkload:
    """Arrivals drawn uniformly across tenants.  ``qps`` attaches Poisson
    arrival times at that rate (drawn AFTER the tenant stream, so the
    tenant/query sequence is bit-identical with or without it)."""
    queries_per_tenant = np.asarray(queries_per_tenant, dtype=np.int64)
    rng = np.random.default_rng(seed)
    tenants = rng.integers(0, queries_per_tenant.shape[0], size=n_ops)
    tenants = tenants.astype(np.int64)
    return MixedWorkload(
        name="uniform",
        tenant_ids=tenants,
        query_ids=_sequential_query_ids(tenants, queries_per_tenant),
        n_tenants=int(queries_per_tenant.shape[0]),
        arrival_s=None if qps is None else _poisson_arrivals(rng, n_ops, qps),
    )


def zipfian_mix(
    queries_per_tenant, n_ops: int, s: float = 1.2, seed: int = 0,
    qps: float | None = None,
) -> MixedWorkload:
    """Tenant popularity ~ rank^-s: tenant 0 is the hot tenant.

    ``s`` is the Zipf exponent; at s=1.2 and 4 tenants the hot tenant takes
    roughly half the traffic — the skew regime the shared-pool-vs-static-
    partition comparison targets."""
    queries_per_tenant = np.asarray(queries_per_tenant, dtype=np.int64)
    n_tenants = queries_per_tenant.shape[0]
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(n_tenants, s)
    tenants = rng.choice(n_tenants, size=n_ops, p=probs).astype(np.int64)
    return MixedWorkload(
        name=f"zipf(s={s:g})",
        tenant_ids=tenants,
        query_ids=_sequential_query_ids(tenants, queries_per_tenant),
        n_tenants=n_tenants,
        arrival_s=None if qps is None else _poisson_arrivals(rng, n_ops, qps),
    )


def bursty_mix(
    queries_per_tenant, n_ops: int, mean_burst: float = 8.0,
    s: float = 0.0, seed: int = 0, qps: float | None = None,
) -> MixedWorkload:
    """Bursty arrivals: pick a tenant (uniform, or Zipf-s when ``s > 0``),
    emit a geometric-length run of its queries, repeat.  Mean run length is
    ``mean_burst``.  ``qps`` attaches burst-clustered arrival times: a whole
    run lands at one instant, runs spaced so the long-run rate is ``qps``."""
    queries_per_tenant = np.asarray(queries_per_tenant, dtype=np.int64)
    n_tenants = queries_per_tenant.shape[0]
    assert mean_burst >= 1.0
    rng = np.random.default_rng(seed)
    if s > 0:
        probs = _zipf_probs(n_tenants, s)
    else:
        probs = np.full(n_tenants, 1.0 / n_tenants)
    tenants = np.empty(n_ops, dtype=np.int64)
    i = 0
    while i < n_ops:
        t = int(rng.choice(n_tenants, p=probs))
        run = min(int(rng.geometric(1.0 / mean_burst)), n_ops - i)
        tenants[i : i + run] = t
        i += run
    return MixedWorkload(
        name=f"bursty(b={mean_burst:g})",
        tenant_ids=tenants,
        query_ids=_sequential_query_ids(tenants, queries_per_tenant),
        n_tenants=n_tenants,
        arrival_s=None if qps is None else _burst_arrivals(rng, tenants, qps),
    )


MIXES = {
    "uniform": uniform_mix,
    "zipfian": zipfian_mix,
    "bursty": bursty_mix,
}
