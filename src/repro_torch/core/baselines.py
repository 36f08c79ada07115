"""System configurations compared in the paper (§5.2) + breakdown variants (§5.5).

``build_system`` wires an index layout, an access path (record pool vs page
cache), a search algorithm, and an execution mode into one runnable bundle;
``evaluate`` runs a query workload through the engine and reports
recall / QPS / latency / I/O / hit-rate — the axes of Figs. 8-14.

Systems:
  velo       VeloIndex (affinity layout) + record pool + Alg.2 + async
  diskann    FixedIndex (seq)     + page LRU + sync beam search (B=1)
  starling   FixedIndex (shuffle) + page LRU + block search (B=1)
  pipeann    FixedIndex (seq)     + page LRU + pipelined best-first (B=1)
  inmemory   fp32 in-memory Vamana greedy search (no I/O)
Breakdown variants (Fig. 14), all on the VeloANN layout:
  baseline   sync beam search, page cache
  +async     same, B>1
  +record    record pool
  +prefetch  + stride prefetching
  +cbs       + cache-aware pivot  (== velo)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import tracing
from repro_torch.core import distance as distance_mod
from repro_torch.core import search as search_mod
from repro_torch.core.bufferpool import RecordBufferPool
from repro_torch.core.dataset import Dataset, recall_at_k
from repro_torch.core.engine import run_workload
from repro_torch.core.hbm import HbmTier
from repro_torch.core.pagecache import PageCache
from repro_torch.core.quant import QuantizedBase, RabitQuantizer
from repro_torch.core.search import (
    PageAccessor,
    RecordAccessor,
    SearchContext,
    SearchParams,
)
from repro_torch.core.sim import SSD, CostModel, SSDConfig, WorkloadStats
from repro_torch.core.store import FixedIndex, VeloIndex
from repro_torch.core.vamana import VamanaGraph


_DEFAULT_FUSE = False
_DEFAULT_FUSE_ROWS = 256
_DEFAULT_SHARED_RV = False
_DEFAULT_OVERLAP = False
_DEFAULT_CALIBRATION: dict | None = None
_DEFAULT_HBM = False
_DEFAULT_HBM_SLOTS: int | None = None
_DEFAULT_DEVICE_BEAM = False
_DEFAULT_SCHEDULER = "rr"
_DEFAULT_SLA_MS: float | list | None = None


def set_default_fuse(
    on: bool, rows: int | None = None, shared: bool | None = None,
    overlap: bool | None = None,
) -> None:
    """Process-wide default for cross-query fused score dispatch — the hook
    ``benchmarks/run.py --fuse`` threads through (mirrors
    ``distance.set_default_backend``).  ``shared`` flips the rendezvous
    topology every system inherits (one system-wide buffer vs per-worker);
    ``overlap`` lets the shared-rendezvous stall flush overlap another
    worker's in-flight completions instead of draining them first."""
    global _DEFAULT_FUSE, _DEFAULT_FUSE_ROWS, _DEFAULT_SHARED_RV, _DEFAULT_OVERLAP
    _DEFAULT_FUSE = bool(on)
    if rows is not None:
        _DEFAULT_FUSE_ROWS = int(rows)
    if shared is not None:
        _DEFAULT_SHARED_RV = bool(shared)
    if overlap is not None:
        _DEFAULT_OVERLAP = bool(overlap)


def default_fuse() -> tuple[bool, int]:
    return _DEFAULT_FUSE, _DEFAULT_FUSE_ROWS


def default_shared_rendezvous() -> bool:
    return _DEFAULT_SHARED_RV


def default_overlap_flush() -> bool:
    return _DEFAULT_OVERLAP


def set_default_hbm(on: bool, slots: int | None = None) -> None:
    """Process-wide default for the HBM record-cache tier — the hook
    ``benchmarks/run.py --hbm-tier`` threads through.  ``slots`` fixes the
    device slot count (None: match the host pool's slot count)."""
    global _DEFAULT_HBM, _DEFAULT_HBM_SLOTS
    _DEFAULT_HBM = bool(on)
    if slots is not None:
        _DEFAULT_HBM_SLOTS = int(slots)


def default_hbm() -> tuple[bool, int | None]:
    return _DEFAULT_HBM, _DEFAULT_HBM_SLOTS


def set_default_device_beam(on: bool) -> None:
    """Process-wide default for the fused on-device beam step — the hook
    ``benchmarks/run.py --device-beam`` threads through.  When on, search
    coroutines keep their beam state engine-resident and yield one
    ``("beam", ...)`` op per hop instead of downloading raw distances
    (core.beam, docs/beam_step.md)."""
    global _DEFAULT_DEVICE_BEAM
    _DEFAULT_DEVICE_BEAM = bool(on)


def default_device_beam() -> bool:
    return _DEFAULT_DEVICE_BEAM


def set_default_scheduler(
    scheduler: str, sla_ms: float | list | None = None
) -> None:
    """Process-wide default for the coroutine scheduling policy — the hook
    ``benchmarks/run.py --scheduler/--sla-ms`` threads through.  "rr" is
    FIFO round-robin (bitwise the pre-SLA engine); "sla" is EDF ordering by
    the per-tenant deadlines ``sla_ms`` induces (docs/scheduling.md)."""
    global _DEFAULT_SCHEDULER, _DEFAULT_SLA_MS
    from repro_torch.core.scheduling import SCHEDULERS

    assert scheduler in SCHEDULERS, f"unknown scheduler {scheduler!r}"
    _DEFAULT_SCHEDULER = scheduler
    if sla_ms is not None:
        _DEFAULT_SLA_MS = sla_ms


def default_scheduler() -> tuple[str, float | list | None]:
    return _DEFAULT_SCHEDULER, _DEFAULT_SLA_MS


def set_default_calibration(calib: dict | None) -> None:
    """Process-wide per-backend CostModel overrides, as emitted by
    ``benchmarks/calibrate.py`` ({backend: {cost_field: seconds}}).  Systems
    built with ``SystemConfig.calibration=None`` inherit it."""
    global _DEFAULT_CALIBRATION
    _DEFAULT_CALIBRATION = calib


def load_calibration(source) -> dict | None:
    """Normalize a calibration source: a dict passes through, a str/Path is
    read as the JSON file calibrate.py writes, None returns None."""
    if source is None or isinstance(source, dict):
        return source
    import json

    with open(source) as f:
        return json.load(f)


def apply_calibration(cost: CostModel, backend: str, calib: dict | None) -> CostModel:
    """A CostModel with ``calib[backend]``'s measured per-backend constants
    (dispatch / table-upload seconds) replacing the defaults.  Unknown keys
    are ignored so calibration files can carry extra diagnostics."""
    overrides = (calib or {}).get(backend)
    if not overrides:
        return cost
    fields = {f.name for f in dataclasses.fields(CostModel)}
    return dataclasses.replace(
        cost, **{k: float(v) for k, v in overrides.items() if k in fields}
    )


@dataclasses.dataclass
class SystemConfig:
    name: str = "velo"
    buffer_ratio: float = 0.2     # memory budget as a fraction of disk index size
    page_size: int = 4096
    n_workers: int = 1
    batch_size: int = 8           # B (1 == synchronous)
    params: SearchParams = dataclasses.field(default_factory=SearchParams)
    tau_scale: float = 1.0        # 0 disables co-placement
    adj_codec: str = "pef"
    page_policy: str = "lru"
    co_admit: bool = True         # colored co-admission (§3.4 fetch rule)
    async_load: bool = True       # LOCKED-window loads + record coalescing
                                  # (False: legacy synchronous per-record admits)
    group_demote: bool = False    # clock demotes co-admitted groups together
    track_access: bool = False    # per-vertex/page counters (Fig. 4)
    seed: int = 0
    distance_backend: str = "torch"  # scalar | batch | torch | default
    device: str | None = None     # torch backend device (None -> process
                                  # default, the CUDA card; "cpu" runs the
                                  # kernels' plain PyTorch versions)
    fuse: bool | None = None      # cross-query fused dispatch (None -> process default)
    fuse_rows: int | None = None  # rendezvous flush row budget (None -> default)
    shared_rendezvous: bool | None = None  # one system-wide rendezvous buffer
                                  # spanning all workers (None -> process
                                  # default; off = per-worker buffers)
    overlap_flush: bool | None = None  # overlap the shared-rendezvous stall
                                  # flush with other workers' in-flight
                                  # completions (None -> process default)
    tenant_quota: float | None = None  # serving plane: per-tenant soft cap on
                                  # shared-pool slots, as a fraction of the
                                  # pool (None/0 = pure global clock)
    resident_plane: bool = True   # register-once resident tables + id-based
                                  # refine requests (False = host-gather
                                  # semantics: per-call row materialization)
    calibration: dict | str | None = None  # per-backend CostModel overrides
                                  # ({backend: {field: s}} or a path to
                                  # calibrate.py's JSON; None -> process default)
    hbm_tier: bool | None = None  # device-resident record-cache tier above
                                  # the host pool (None -> process default;
                                  # only record-pool systems build one)
    hbm_slots: int | None = None  # HBM tier slot count (None -> process
                                  # default, which falls back to the host
                                  # pool's slot count)
    device_beam: bool | None = None  # fused on-device beam step: one
                                  # ("beam", ...) op per hop — score +
                                  # visited mask + top-k merge + frontier
                                  # selection in a single engine call, reply
                                  # is the FRONTIER (None -> process
                                  # default; off = the host-beam bitwise
                                  # reference path)
    n_shards: int | None = None   # sharded scatter-gather serving plane
                                  # (core.sharding): split the index image
                                  # across this many engine shards, each with
                                  # its own SSD, rendezvous buffer, and
                                  # clock; score work scatters to the owning
                                  # shards and merges per flush.  None/0 =
                                  # unsharded.  n_shards=1 is bitwise
                                  # identical to unsharded (the parity
                                  # contract bench_sharded.py enforces).
    scheduler: str | None = None  # coroutine scheduling policy: "rr" = FIFO
                                  # round-robin, bitwise the pre-SLA engine;
                                  # "sla" = EDF by deadline slack (admission,
                                  # ready picks, stall-flush initiator), fed
                                  # by sla_ms deadlines (None -> process
                                  # default; see docs/scheduling.md)
    sla_ms: float | list | None = None  # per-tenant latency target in ms
                                  # (scalar = every tenant; sequence = one
                                  # per tenant).  Induces per-query deadlines
                                  # arrival + sla; powers deadline hit-rate
                                  # accounting and the SLA feedback loop.
    sla_feedback: bool = True     # in sla mode with sla_ms set: run the
                                  # online feedback controller (beam width /
                                  # tenant quota / fuse_rows steering).  Off
                                  # = pure EDF, the schedule-invariant mode
                                  # the explorer covers.
    verify_protocol: bool = False  # arm the dynamic protocol checker
                                  # (repro_torch.analysis.protocol): validates
                                  # every pool/HBM slot transition against the
                                  # Fig. 5 spec, runs cheap invariants at
                                  # each flush boundary, and raises at the
                                  # end of run() on any violation.  Purely
                                  # observational and host-only: results are
                                  # bitwise identical to an unverified run.


@dataclasses.dataclass
class System:
    """A runnable ANN system: index + cache + algorithm + engine config."""

    name: str
    config: SystemConfig
    index: object
    ctx: SearchContext
    algorithm: object
    store: object
    cost: CostModel
    hbm: object | None = None  # HbmTier when the device record tier is on
    checker: object | None = None  # ProtocolChecker when verify_protocol is on
    shard_plan: object | None = None  # sharding.ShardPlan when n_shards is set

    def make_coroutine(self, qid: int, q: np.ndarray):
        return self.algorithm(self.ctx, q, self.config.params)

    def run(
        self, queries: np.ndarray, ssd_config: SSDConfig | None = None,
        schedule=None, sla=None,
    ) -> tuple[list, WorkloadStats]:
        # the span's self time: the scheduler loop, the event heap, read
        # issue, the SSD model and op dispatch
        sp = tracing.begin(tracing.ENGINE_RUN) if tracing.on else -1
        ssd = SSD(ssd_config)
        shards = None
        if self.shard_plan is not None:
            # fresh per run, like the SSD: shard clocks start at zero and
            # every shard's device starts idle
            from repro_torch.core import sharding as sharding_mod

            shards = sharding_mod.ShardRouter(self.shard_plan, ssd_config)
        pool = getattr(self.ctx.accessor, "pool", None)
        pressure0 = (
            dict(pool.pressure_stats())
            if pool is not None and hasattr(pool, "pressure_stats") else None
        )
        # snapshot cumulative accessor counters so repeated run()/evaluate()
        # calls on one system report THIS run's delta, not a double count
        hits0, misses0 = self.ctx.accessor.stats()
        results, stats = run_workload(
            self.make_coroutine,
            queries,
            store=self.store,
            cost=self.cost,
            ssd=ssd,
            n_workers=self.config.n_workers,
            batch_size=self.config.batch_size,
            page_size=self.config.page_size,
            dist=self.ctx.dist,
            qb=self.ctx.qb,
            fuse=self.config.fuse,
            fuse_rows=self.config.fuse_rows,
            shared_rendezvous=bool(self.config.shared_rendezvous),
            overlap_flush=bool(self.config.overlap_flush),
            scheduler=self.config.scheduler or "rr",
            hbm=self.hbm,
            schedule=schedule,
            verify=self.checker,
            shards=shards,
            sla=sla,
        )
        if self.checker is not None:
            self.checker.raise_if_violations()
        hits, misses = self.ctx.accessor.stats()
        stats.cache_hits = hits - hits0
        stats.cache_misses = misses - misses0
        if pressure0 is not None:
            # the ONE pool instance is shared by all n_workers; report this
            # run's delta of its pressure counters (the engine counts
            # lock_waits/coalesced too, but only for ops it scheduled)
            for key, val in pool.pressure_stats().items():
                setattr(stats, key, val - pressure0[key])
        if sp >= 0:
            tracing.end(sp)
        return results, stats

    # ---- memory accounting (Table 3) ----
    def disk_bytes(self) -> int:
        return self.index.disk_bytes()

    def memory_bytes(self) -> int:
        """Resident metadata + buffer budget (paper §5.3 footprint analysis).
        The HBM tier's slot arrays count toward the total so tiered and
        host-only configurations compare at equal memory."""
        total = self.index.resident_bytes() + int(
            self.config.buffer_ratio * self.index.disk_bytes()
        )
        if self.hbm is not None:
            total += self.hbm.nbytes()
        return total


# ----------------------------------------------------------------- builders


def _record_slot_bytes(dim: int, R: int) -> int:
    # decoded record: ext code (d/2) + lo/step (8) + adjacency ids (4R logical)
    return dim // 2 + 8 + 4 * R


_BREAKDOWN = {
    "baseline": dict(algo="diskann", pool="page", batch=1, prefetch=False, cbs=False),
    "+async": dict(algo="diskann", pool="page", batch=None, prefetch=False, cbs=False),
    "+record": dict(algo="diskann", pool="record", batch=None, prefetch=False, cbs=False),
    "+prefetch": dict(algo="velo", pool="record", batch=None, prefetch=True, cbs=False),
    "+cbs": dict(algo="velo", pool="record", batch=None, prefetch=True, cbs=True),
}


def build_system(
    name: str,
    base: np.ndarray,
    graph: VamanaGraph,
    qb: QuantizedBase,
    config: SystemConfig | None = None,
    cost: CostModel | None = None,
) -> System:
    config = config or SystemConfig()
    fuse_on, fuse_rows = default_fuse()
    config = dataclasses.replace(
        config,
        name=name,
        fuse=fuse_on if config.fuse is None else config.fuse,
        fuse_rows=fuse_rows if config.fuse_rows is None else config.fuse_rows,
        shared_rendezvous=(
            default_shared_rendezvous()
            if config.shared_rendezvous is None else config.shared_rendezvous
        ),
        overlap_flush=(
            default_overlap_flush()
            if config.overlap_flush is None else config.overlap_flush
        ),
        hbm_tier=(
            default_hbm()[0] if config.hbm_tier is None else config.hbm_tier
        ),
        hbm_slots=(
            default_hbm()[1] if config.hbm_slots is None else config.hbm_slots
        ),
        device_beam=(
            default_device_beam()
            if config.device_beam is None else config.device_beam
        ),
        scheduler=(
            default_scheduler()[0]
            if config.scheduler is None else config.scheduler
        ),
        sla_ms=(
            default_scheduler()[1]
            if config.sla_ms is None else config.sla_ms
        ),
    )
    cost = cost or CostModel()
    # ONE engine per system (its name keys the calibration lookup)
    dist_engine = distance_mod.get_engine(
        config.distance_backend, resident=config.resident_plane,
        device=config.device,
    )
    calib = load_calibration(
        config.calibration if config.calibration is not None
        else _DEFAULT_CALIBRATION
    )
    if calib:
        cost = apply_calibration(cost, dist_engine.name, calib)
    n, dim = base.shape

    def record_pool_for(index) -> RecordAccessor:
        # ONE pool instance per system: all n_workers' coroutines share it,
        # coalescing on the same LOCKED windows and hot records.
        budget = config.buffer_ratio * index.disk_bytes()
        n_slots = max(8, int(budget // _record_slot_bytes(dim, graph.R)))
        pool = RecordBufferPool(min(n_slots, n), index.layout.vid_to_page,
                                group_demote=config.group_demote)
        return RecordAccessor(index, pool, cost, co_admit=config.co_admit,
                              track_access=config.track_access,
                              async_load=config.async_load)

    def page_cache_for(index) -> PageAccessor:
        budget = config.buffer_ratio * index.disk_bytes()
        pages = max(4, int(budget // config.page_size))
        cache = PageCache(pages, policy=config.page_policy, seed=config.seed)
        return PageAccessor(index, cache, cost, track_access=config.track_access)

    if name == "velo":
        index = VeloIndex(
            base, graph, qb,
            adj_codec=config.adj_codec,
            page_size=config.page_size,
            tau_scale=config.tau_scale,
        )
        acc = record_pool_for(index)
        algo = search_mod.velo_search
        refine = cost.refine_ext(dim)
        batch = config.batch_size
    elif name == "velo-page":
        # VeloANN layout + Alg. 2 but page-granular caching (Fig. 13's VeloANN-Page)
        index = VeloIndex(
            base, graph, qb,
            adj_codec=config.adj_codec,
            page_size=config.page_size,
            tau_scale=config.tau_scale,
        )
        acc = page_cache_for(index)
        algo = search_mod.velo_search
        refine = cost.refine_ext(dim)
        batch = config.batch_size
    elif name == "diskann":
        index = FixedIndex(base, graph, qb, page_size=config.page_size, shuffle=False)
        acc = page_cache_for(index)
        algo = search_mod.diskann_search
        refine = cost.refine_full(dim)
        batch = 1  # synchronous
    elif name == "starling":
        index = FixedIndex(base, graph, qb, page_size=config.page_size, shuffle=True)
        acc = page_cache_for(index)
        algo = search_mod.starling_search
        refine = cost.refine_full(dim)
        batch = 1
    elif name == "pipeann":
        index = FixedIndex(base, graph, qb, page_size=config.page_size, shuffle=False)
        acc = page_cache_for(index)
        algo = search_mod.pipeann_search
        refine = cost.refine_full(dim)
        batch = 1
    elif name == "inmemory":
        index = VeloIndex(base, graph, qb, page_size=config.page_size, tau_scale=0.0)
        acc = record_pool_for(index)  # unused: algorithm never touches disk
        algo = search_mod.inmemory_search
        refine = cost.refine_full(dim)
        batch = config.batch_size
    elif name in _BREAKDOWN:
        spec = _BREAKDOWN[name]
        index = VeloIndex(
            base, graph, qb,
            adj_codec=config.adj_codec,
            page_size=config.page_size,
            tau_scale=config.tau_scale,
        )
        acc = record_pool_for(index) if spec["pool"] == "record" else page_cache_for(index)
        algo = search_mod.ALGORITHMS[spec["algo"]]
        refine = cost.refine_ext(dim)
        batch = spec["batch"] or config.batch_size
        config = dataclasses.replace(
            config,
            params=dataclasses.replace(
                config.params, prefetch=spec["prefetch"], cbs=spec["cbs"]
            ),
        )
    else:
        raise ValueError(f"unknown system {name!r}")

    config = dataclasses.replace(config, batch_size=batch)
    shard_plan = None
    if config.n_shards:
        # the sharded scatter-gather plane: page->shard ownership derived
        # from the layout (pages are the affinity-preserving atomic unit)
        from repro_torch.core import sharding as sharding_mod

        shard_plan = sharding_mod.plan_for_index(index, config.n_shards)
    hbm = None
    if (
        config.hbm_tier
        and not config.n_shards  # tier rides the unsharded dispatch path
        and name != "inmemory"
        and isinstance(acc, RecordAccessor)
        and isinstance(index, VeloIndex)
    ):
        # second cache tier ABOVE the host pool: device slots holding full
        # records; the accessor consults it first and the pool's publish
        # hook drains the miss list into staged scatters
        slots = config.hbm_slots or acc.pool.n_slots
        hbm = HbmTier(qb, index.layout.vid_to_page,
                      n_slots=max(8, min(int(slots), n)), R=graph.R)
        acc.hbm = hbm
        acc.pool.on_publish = hbm.note_publish
    checker = None
    if config.verify_protocol:
        # lazy import: core stays import-independent of the analysis layer
        from repro_torch.analysis.protocol import ProtocolChecker

        checker = ProtocolChecker()
        if hbm is not None:
            # order matters: shadow the tier's entry points FIRST, then
            # re-point the pool's publish hook at the (now wrapped) staging
            # method, then let watch_pool chain its double-publish probe in
            # front of it — otherwise the pool keeps calling the raw bound
            # method captured above and staging goes unobserved
            checker.watch_hbm(hbm)
            acc.pool.on_publish = hbm.note_publish
        pool = getattr(acc, "pool", None)
        if pool is not None:
            checker.watch_pool(pool)
    ctx = SearchContext(
        index=index,
        qb=qb,
        accessor=acc,
        cost=cost,
        medoid=graph.medoid,
        base=base if name == "inmemory" else None,
        refine_cost_s=refine,
        dist=dist_engine,
        resident_ids=config.resident_plane,
        shard_plan=shard_plan,
        device_beam=bool(config.device_beam),
    )
    return System(
        name=name,
        config=config,
        index=index,
        ctx=ctx,
        algorithm=algo,
        store=index.store,
        cost=cost,
        hbm=hbm,
        checker=checker,
        shard_plan=shard_plan,
    )


def evaluate(
    system: System,
    ds: Dataset,
    ssd_config: SSDConfig | None = None,
) -> dict:
    """Run all dataset queries; return the paper's metrics.

    Stats collection is idempotent: the distance engine's cumulative counters
    are snapshotted around the run, so calling ``evaluate`` twice on one
    system reports each run's own dispatches/uploads — not a double count."""
    dist0 = dataclasses.replace(system.ctx.dist.stats)
    results, stats = system.run(ds.queries, ssd_config)
    dist1 = system.ctx.dist.stats
    k = ds.k
    ids = np.full((len(results), k), -1, dtype=np.int64)
    for i, r in enumerate(results):
        m = min(k, len(r.ids))
        ids[i, :m] = r.ids[:m]
    rec = recall_at_k(ids, ds.groundtruth, k)
    # combined two-tier hit rate: an access is a hit if EITHER tier served it
    # (tier misses fall through to the pool, so pool counters already exclude
    # tier hits — the sum is disjoint)
    served = stats.hbm_hits + stats.cache_hits
    accesses = served + stats.cache_misses
    combined = served / accesses if accesses else 0.0
    return {
        "system": system.name,
        "distance_backend": system.ctx.dist.name,
        "fuse": bool(system.config.fuse),
        "shared_rendezvous": bool(system.config.shared_rendezvous),
        "overlap_flush": bool(system.config.overlap_flush),
        "resident_plane": bool(system.config.resident_plane),
        "scheduler": system.config.scheduler or "rr",
        "recall@k": rec,
        "qps": stats.qps,
        "mean_latency_ms": stats.mean_latency_ms,
        "p99_latency_ms": stats.p99_latency_ms(),
        "mean_service_ms": stats.mean_service_ms,
        "queue_wait_s": stats.queue_wait_s,
        "deadline_hit_rate": stats.deadline_hit_rate,
        "ios_per_query": stats.ios_per_query,
        "coalesced_reads": stats.coalesced_reads,
        "hit_rate": stats.hit_rate,
        "lock_waits": stats.lock_waits,
        "coalesced_record_loads": stats.coalesced_record_loads,
        "group_admits": stats.group_admits,
        "clock_skips": stats.clock_skips,
        "overlap_flushes": stats.overlap_flushes,
        "disk_bytes": system.disk_bytes(),
        "memory_bytes": system.memory_bytes(),
        "mean_hops": float(np.mean([r.hops for r in results])),
        "dist_dispatches": dist1.dispatches() - dist0.dispatches(),
        "dist_uploads": dist1.uploads - dist0.uploads,
        "resident_gathers": dist1.resident_gathers - dist0.resident_gathers,
        "score_requests_per_flush": stats.requests_per_flush,
        "score_rows_per_flush": stats.rows_per_flush,
        "n_shards": system.config.n_shards or 0,
        "scatter_ops": stats.scatter_ops,
        "shard_flushes": stats.shard_flushes,
        "shard_merges": stats.shard_merges,
        "device_beam": bool(system.config.device_beam),
        "beam_ops": stats.beam_ops,
        "beam_flushes": stats.beam_flushes,
        "beam_rows": stats.beam_rows,
        "beam_steps": dist1.beam_steps - dist0.beam_steps,
        "dist_downloads": stats.dist_downloads,
        "downloads_per_query": stats.downloads_per_query,
        "hbm_tier": system.hbm is not None,
        "hbm_hits": stats.hbm_hits,
        "hbm_misses": stats.hbm_misses,
        "hbm_hit_rate": stats.hbm_hit_rate,
        "hbm_scatters": stats.hbm_scatters,
        "hbm_evictions": stats.hbm_evictions,
        "combined_hit_rate": combined,
    }
