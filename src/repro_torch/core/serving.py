"""Multi-tenant serving plane: N independent indexes on ONE engine.

The single-system stack keeps one index saturating the hardware; a
production deployment hosts MANY indexes — tenants — on the same machine.
``ServingPlane`` composes the existing pieces into that shape without forking
any of them:

  * one ``Engine`` runs every tenant's query coroutines on the same simulated
    workers (one scheduler, one SSD, one completion queue), over ONE combined
    ``PageStore`` whose page-id space concatenates the tenants' index images;
  * one ``RecordBufferPool`` is shared by every record-pool tenant: the vid
    namespace is globalized (``vid + vid_base``) through a ``TenantPoolView``,
    so tenants compete for — and coalesce on — the same slots, LOCKED windows
    and clock hand.  Per-tenant *soft quotas* (``SystemConfig.tenant_quota``)
    cap any tenant's slot share: an over-quota tenant recycles its own slots
    via a tenant-scoped second-chance sweep; quota off is the pure global
    clock.  ``shared_pool=False`` statically partitions instead (each tenant
    keeps its isolated-system pool size) — the baseline the shared pool is
    benchmarked against, and the mode whose behavior is bit-identical to N
    isolated systems (the isolation contract, tests/test_torch_serving.py);
  * one ``DistanceEngine`` serves every tenant's score requests.  When all
    tenants share a dimensionality, their quantized tables are concatenated
    into ONE combined table registered once (``combined_table``): requests
    carry global row ids into it, so a single rendezvous flush fuses the
    frontiers of queries from DIFFERENT tenants into one kernel dispatch
    (on the ``torch`` engine: one ``binary_ip`` estimate launch, one
    ``int4_dist`` refine launch over the combined table on the card) —
    cross-tenant fusion as pure routing, no new wire format.  Tenants with
    mismatched shapes keep their own registered tables; ``execute_requests``
    then routes each (kind, table) group to its own fused call.

Per-tenant accounting: each tenant's accessor counts its own hits/misses
(``TenantPoolView`` mirrors the pool's hit/miss rules), per-query latencies
are split by the engine's ``latency_qids``, and ``PlaneRun.tenants`` carries
one ``WorkloadStats`` + recall per tenant — the serving-side axes (recall /
QPS / p99 / hit rate) sliced the way an operator would dashboard them.

Workloads come from ``repro_torch.core.workload`` (uniform / zipfian
hot-tenant / bursty arrival mixes).  The plane's ``SystemConfig.device``
picks the torch engine's device like ``build_system``'s (None: the process
default, the CUDA card).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import baselines as baselines_mod
from repro_torch.core import distance as distance_mod
from repro_torch.core.bufferpool import RecordBufferPool
from repro_torch.core.dataset import recall_at_k
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.hbm import HbmTier, HbmView
from repro_torch.core.pagecache import PageCache
from repro_torch.core.quant import QuantizedBase
from repro_torch.core.scheduling import SlaController, SlaPlan, sla_seconds
from repro_torch.core.search import PageAccessor, RecordAccessor, SearchParams
from repro_torch.core.sim import SSD, SSDConfig, WorkloadStats
from repro_torch.core.store import PageStore
from repro_torch.core.workload import MixedWorkload


# ------------------------------------------------------------ combined table


def combined_table(qbs: list[QuantizedBase]) -> QuantizedBase | None:
    """Concatenate tenants' quantized tables into one registerable table.

    Row i of tenant t lives at global row ``vid_base[t] + i``; each row keeps
    the codes built under ITS tenant's rotation, and each query's
    ``PreparedQuery`` is prepared under that same rotation, so per-row scoring
    is unchanged — the batch primitives only consume per-row data plus the
    shared dimensionality.  Returns None when the tenants' shapes are not
    combinable (different dim or ext width); callers then fall back to
    per-tenant registered tables.

    The combined object's ``centroid``/``rotation`` are copied from the first
    tenant purely to satisfy the dataclass shape — scoring never reads them
    (queries are prepared against each tenant's OWN qb)."""
    if not qbs:
        return None
    d0, e0 = qbs[0].dim, qbs[0].ext_bits
    if any(q.dim != d0 or q.ext_bits != e0 for q in qbs):
        return None
    return QuantizedBase(
        centroid=qbs[0].centroid,
        rotation=qbs[0].rotation,
        binary_codes=np.concatenate([q.binary_codes for q in qbs]),
        norms=np.concatenate([q.norms for q in qbs]),
        ip_bar=np.concatenate([q.ip_bar for q in qbs]),
        ext_codes=np.concatenate([q.ext_codes for q in qbs]),
        ext_lo=np.concatenate([q.ext_lo for q in qbs]),
        ext_step=np.concatenate([q.ext_step for q in qbs]),
        dim=d0,
        ext_bits=e0,
    )


# ------------------------------------------------------------- tenant views


class _TenantIndexView:
    """A tenant's index seen through the plane's global page-id space: reads
    issued by this tenant's coroutines address the combined store.  Record
    decoding, co-residency and payloads stay local — only page ids shift."""

    def __init__(self, index, page_base: int):
        self._index = index
        self._page_base = page_base

    def page_of(self, vid: int) -> int:
        return self._index.page_of(vid) + self._page_base

    def page_record_ids(self, pid: int) -> list[int]:
        return self._index.page_record_ids(pid - self._page_base)

    def __getattr__(self, name):
        return getattr(self._index, name)


class TenantPoolView:
    """A tenant's handle on the shared ``RecordBufferPool``: translates the
    tenant's local vid namespace into the plane's global one and keeps the
    tenant's own hit/miss counters (mirroring the pool's counting rules), so
    ``RecordAccessor.stats()`` reports per-tenant hit rates while the pool's
    totals stay system-wide.  The engine's ``load_wait`` protocol works
    through the view unchanged — waiter parking and resume draining hit the
    one shared pool, so coalescing spans tenants."""

    def __init__(self, pool: RecordBufferPool, vid_base: int):
        self.shared = pool
        self.vid_base = vid_base
        self.hits = 0
        self.misses = 0

    # ---- lookups (tenant-attributed stats) --------------------------------
    def lookup(self, vid: int):
        rec = self.shared.lookup(vid + self.vid_base)
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    # ---- namespace-translating delegates ----------------------------------
    def admit(self, vid: int, record) -> int:
        return self.shared.admit(vid + self.vid_base, record)

    def admit_group(self, vids, records) -> int:
        return self.shared.admit_group(
            [int(v) + self.vid_base for v in vids], records
        )

    def begin_load(self, vid: int) -> int:
        return self.shared.begin_load(vid + self.vid_base)

    def finish_load(self, vid: int, record) -> int:
        return self.shared.finish_load(vid + self.vid_base, record)

    def abort_load(self, vid: int) -> None:
        self.shared.abort_load(vid + self.vid_base)

    def is_loading(self, vid: int) -> bool:
        return self.shared.is_loading(vid + self.vid_base)

    def peek_resident(self, vid: int) -> bool:
        return self.shared.peek_resident(vid + self.vid_base)

    def peek_present(self, vid: int) -> bool:
        return self.shared.peek_present(vid + self.vid_base)

    def peek_record(self, vid: int):
        return self.shared.peek_record(vid + self.vid_base)

    def status(self, vid: int) -> str:
        return self.shared.status(vid + self.vid_base)

    def add_waiter(self, vid: int, waiter) -> None:
        self.shared.add_waiter(vid + self.vid_base, waiter)

    # ---- engine resume-drain protocol (shared, not translated) ------------
    @property
    def pending_resumes(self):
        return self.shared.pending_resumes

    def take_resumes(self):
        return self.shared.take_resumes()

    def pressure_stats(self) -> dict[str, int]:
        return self.shared.pressure_stats()

    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


# ------------------------------------------------------------------ tenants


@dataclasses.dataclass
class TenantSpec:
    """One tenant: an index image plus its query workload."""

    name: str
    base: np.ndarray
    graph: object                  # VamanaGraph
    qb: QuantizedBase
    queries: np.ndarray
    groundtruth: np.ndarray | None = None
    system: str = "velo"           # any baselines.build_system name
    params: SearchParams | None = None

    @classmethod
    def from_dataset(cls, name, ds, graph, qb, system="velo", params=None):
        return cls(
            name=name, base=ds.base, graph=graph, qb=qb, queries=ds.queries,
            groundtruth=ds.groundtruth, system=system, params=params,
        )


@dataclasses.dataclass
class Tenant:
    """A hosted tenant: the built single-system pieces rewired to the plane."""

    tid: int
    spec: TenantSpec
    system: object                 # the baselines.System it was built from
    ctx: object                    # SearchContext (plane-wired)
    accessor: object               # RecordAccessor | PageAccessor
    algorithm: object
    params: SearchParams
    vid_base: int
    page_base: int

    @property
    def name(self) -> str:
        return self.spec.name


@dataclasses.dataclass
class TenantRun:
    """One tenant's slice of a plane run."""

    name: str
    tid: int
    results: list                  # QueryResult per arrival, arrival order
    stats: WorkloadStats
    recall: float | None           # None when the spec has no groundtruth

    @property
    def hit_rate(self) -> float:
        return self.stats.hit_rate


@dataclasses.dataclass
class PlaneRun:
    results: list                  # all queries, arrival order
    stats: WorkloadStats           # system-wide
    tenants: list[TenantRun]


def _vid_to_page(index) -> np.ndarray:
    """Index-format-agnostic vid -> local page id array."""
    if hasattr(index, "layout"):
        return np.asarray(index.layout.vid_to_page, dtype=np.int64)
    return np.asarray(index.vid_to_page, dtype=np.int64)


# ------------------------------------------------------------ serving plane


class ServingPlane:
    """N tenants, one engine, one (optionally shared) buffer pool."""

    def __init__(
        self,
        specs: list[TenantSpec],
        config: baselines_mod.SystemConfig | None = None,
        cost=None,
        shared_pool: bool = True,
    ):
        assert specs, "a serving plane needs at least one tenant"
        self.config = config or baselines_mod.SystemConfig()
        self.shared_pool_mode = shared_pool

        # ---- per-tenant builds (index image, algorithm, resolved config) --
        built = []
        for spec in specs:
            cfg_t = dataclasses.replace(
                self.config,
                params=spec.params if spec.params is not None else self.config.params,
            )
            built.append(baselines_mod.build_system(
                spec.system, spec.base, spec.graph, spec.qb, cfg_t, cost
            ))
        page_sizes = {b.config.page_size for b in built}
        assert len(page_sizes) == 1, "tenants must share one page size"
        self.page_size = page_sizes.pop()

        # ---- combined page store: one global page-id space ----------------
        page_bases, vid_bases = [], []
        pages: list[bytes] = []
        nv = 0
        for b in built:
            page_bases.append(len(pages))
            vid_bases.append(nv)
            pages.extend(b.index.store.pages)
            nv += b.index.n
        self.store = PageStore(pages, self.page_size)
        self.n_vids = nv

        # ---- one distance engine + (when combinable) one combined table ---
        self.dist = distance_mod.get_engine(
            self.config.distance_backend, resident=self.config.resident_plane,
            device=self.config.device,
        )
        self.table = combined_table([s.qb for s in specs])

        # ---- the pool plane: shared-with-quotas or static partition -------
        record_tenants = [
            i for i, b in enumerate(built)
            if isinstance(b.ctx.accessor, RecordAccessor)
        ]
        self.pool: RecordBufferPool | None = None
        if shared_pool and record_tenants:
            tenant_of = np.concatenate([
                np.full(b.index.n, i, dtype=np.int64)
                for i, b in enumerate(built)
            ])
            global_vtp = np.concatenate([
                _vid_to_page(b.index) + page_bases[i]
                for i, b in enumerate(built)
            ])
            n_slots = min(
                sum(built[i].ctx.accessor.pool.n_slots for i in record_tenants),
                sum(built[i].index.n for i in record_tenants),
            )
            self.pool = RecordBufferPool(
                n_slots, global_vtp,
                group_demote=self.config.group_demote,
                tenant_of=tenant_of,
                tenant_quota=self.config.tenant_quota,
            )

        # ---- HBM record tier above the shared pool ------------------------
        # One device cache for the whole plane, addressed by GLOBAL vids over
        # the combined table (required: slot gathers index the one registered
        # table).  Static-partition mode gets no tier — it is the baseline.
        self.hbm: HbmTier | None = None
        hbm_on = (
            baselines_mod.default_hbm()[0]
            if self.config.hbm_tier is None else self.config.hbm_tier
        )
        if hbm_on and self.pool is not None and self.table is not None:
            slots = (
                self.config.hbm_slots
                or baselines_mod.default_hbm()[1]
                or self.pool.n_slots
            )
            max_r = max(int(s.graph.R) for s in specs)
            self.hbm = HbmTier(
                self.table, global_vtp,
                n_slots=max(8, min(int(slots), self.n_vids)), R=max_r,
            )
            self.pool.on_publish = self.hbm.note_publish

        # ---- rewire each tenant onto the plane ----------------------------
        self.tenants: list[Tenant] = []
        for i, (spec, b) in enumerate(zip(specs, built)):
            view = _TenantIndexView(b.index, page_bases[i])
            old_acc = b.ctx.accessor
            if isinstance(old_acc, RecordAccessor):
                if self.pool is not None:
                    handle = TenantPoolView(self.pool, vid_bases[i])
                else:
                    # static partition: the tenant keeps its isolated-system
                    # pool size, addressed in the global page space
                    handle = RecordBufferPool(
                        old_acc.pool.n_slots,
                        _vid_to_page(b.index) + page_bases[i],
                        group_demote=self.config.group_demote,
                    )
                # track_access is off on the plane: the Fig. 4 counters are
                # sized to one tenant's local page space, not the global one
                acc = RecordAccessor(
                    view, handle, b.cost,
                    co_admit=self.config.co_admit,
                    async_load=self.config.async_load,
                    hbm=(
                        HbmView(self.hbm, vid_bases[i])
                        if self.hbm is not None else None
                    ),
                )
            else:
                acc = PageAccessor(
                    view, PageCache(
                        old_acc.cache.capacity,
                        policy=self.config.page_policy,
                        seed=self.config.seed,
                    ),
                    b.cost,
                )
            ctx = dataclasses.replace(
                b.ctx,
                index=view,
                accessor=acc,
                dist=self.dist,
                table_qb=self.table if self.table is not None else spec.qb,
                vid_base=vid_bases[i] if self.table is not None else 0,
                tenant=i,
            )
            self.tenants.append(Tenant(
                tid=i, spec=spec, system=b, ctx=ctx, accessor=acc,
                algorithm=b.algorithm, params=b.config.params,
                vid_base=vid_bases[i], page_base=page_bases[i],
            ))

        # ---- dynamic protocol checker (SystemConfig.verify_protocol) ------
        # wired AFTER the tenant rewire so static-partition per-tenant pools
        # exist to be watched too; the hbm-first / re-point-hook / pool-last
        # order is the same rule build_system follows
        self.checker = None
        if self.config.verify_protocol:
            from repro_torch.analysis.protocol import ProtocolChecker

            self.checker = ProtocolChecker()
            if self.hbm is not None:
                self.checker.watch_hbm(self.hbm)
                if self.pool is not None:
                    self.pool.on_publish = self.hbm.note_publish
            if self.pool is not None:
                self.checker.watch_pool(self.pool)
            for t in self.tenants:
                p = getattr(t.accessor, "pool", None)
                if isinstance(p, RecordBufferPool) and p is not self.pool:
                    self.checker.watch_pool(p)

        # sync tenants (diskann/starling/pipeann are B=1 systems) clamp the
        # shared engine's per-worker batch: one scheduler serves everyone
        self.batch_size = min(b.config.batch_size for b in built)
        cfg0 = built[0].config
        self.engine_config = EngineConfig(
            n_workers=self.config.n_workers,
            batch_size=self.batch_size,
            page_size=self.page_size,
            fuse=bool(cfg0.fuse),
            fuse_rows=cfg0.fuse_rows,
            shared_rendezvous=bool(cfg0.shared_rendezvous),
            overlap_flush=bool(cfg0.overlap_flush),
            scheduler=cfg0.scheduler,
        )
        # resolve the None->process-default fields run() reads off the
        # plane's own config (build_system resolved them on each tenant)
        self.config = dataclasses.replace(
            self.config, scheduler=cfg0.scheduler, sla_ms=cfg0.sla_ms,
        )
        self.cost = built[0].cost

    # ------------------------------------------------------------------ run

    def run(
        self, workload: MixedWorkload, ssd_config: SSDConfig | None = None,
        schedule=None,
    ) -> PlaneRun:
        """Run a mixed arrival stream through the one engine; split the
        results and the serving metrics by tenant.  Stats are per-run deltas
        (idempotent across repeated runs on one plane).

        Tenant-count honesty: ``workload.n_tenants`` carries the TRUE tenant
        count from the generator — a cold tenant that drew zero arrivals
        still counts (the per-tenant split below reports its empty row
        instead of silently dropping it).  The guard rejects workloads
        generated for more tenants than the plane serves, which used to slip
        through whenever the excess tenants happened to draw no arrivals.
        (Scaling one tenant's INDEX across engine shards is the orthogonal
        axis — see docs/sharding.md.)"""
        tenants = self.tenants
        assert workload.n_tenants <= len(tenants), (
            f"workload generated for {workload.n_tenants} tenants, plane "
            f"serves {len(tenants)}"
        )
        queries = [
            tenants[int(t)].spec.queries[int(j)]
            for t, j in zip(workload.tenant_ids, workload.query_ids)
        ]

        # ---- SLA plan: arrivals + per-tenant deadlines + feedback ---------
        # Built whenever the run has any SLA surface (the "sla" scheduler, a
        # workload with arrival timestamps, or deadlines configured); plain
        # rr batch runs pass plan=None and stay bitwise the pre-SLA plane.
        cfgS = self.config
        sla_plan = None
        controller = None
        if (
            cfgS.scheduler == "sla"
            or workload.arrival_s is not None
            or cfgS.sla_ms is not None
        ):
            if cfgS.sla_ms is not None and cfgS.sla_feedback:
                controller = SlaController(
                    n_tenants=len(tenants),
                    sla_s=sla_seconds(cfgS.sla_ms, len(tenants)),
                    pool=self.pool,
                )
            sla_plan = SlaPlan.build(
                len(queries),
                arrivals=workload.arrival_s,
                sla_ms=cfgS.sla_ms,
                tenant_of=workload.tenant_ids,
                n_tenants=len(tenants),
                controller=controller,
            )

        def make_coroutine(qid: int, q):
            t = tenants[int(workload.tenant_ids[qid])]
            params = t.params
            if controller is not None:
                # the feedback loop's beam steering: the tenant's CURRENT
                # scale decides this query's candidate-list width
                params = controller.params_for(t.tid, params)
            return t.algorithm(t.ctx, q, params)

        # snapshot cumulative counters -> per-run deltas
        acc0 = [t.accessor.stats() for t in tenants]
        reads0 = [t.accessor.reads for t in tenants]
        hbm0 = [
            (t.accessor.hbm.hits, t.accessor.hbm.misses)
            if getattr(t.accessor, "hbm", None) is not None else None
            for t in tenants
        ]
        pools = {id(self.pool): self.pool} if self.pool is not None else {}
        for t in tenants:
            p = getattr(t.accessor, "pool", None)
            if isinstance(p, RecordBufferPool):
                pools[id(p)] = p
        pressure0 = {
            k: dict(p.pressure_stats()) for k, p in pools.items()
        }

        engine = Engine(
            store=self.store,
            ssd=SSD(ssd_config),
            cost=self.cost,
            config=self.engine_config,
            dist=self.dist,
            qb=None,  # every request carries its table (the tenant tag)
            hbm=self.hbm,
            schedule=schedule,
            verify=self.checker,
        )
        results, stats = engine.run(make_coroutine, queries, sla=sla_plan)
        if self.checker is not None:
            self.checker.raise_if_violations()

        # system-wide cache + pool-pressure deltas
        hits = misses = 0
        for t, (h0, m0) in zip(tenants, acc0):
            h1, m1 = t.accessor.stats()
            hits += h1 - h0
            misses += m1 - m0
        stats.cache_hits = hits
        stats.cache_misses = misses
        # the engine counted lock_waits/coalesced_record_loads for the ops it
        # scheduled; REPLACE them with the pools' own per-run deltas (summed
        # across the shared pool or the partition's per-tenant pools) rather
        # than adding on top — the same rule System.run applies
        if pools:
            stats.lock_waits = 0
            stats.coalesced_record_loads = 0
        for k, p in pools.items():
            for key, val in p.pressure_stats().items():
                setattr(stats, key,
                        getattr(stats, key) + val - pressure0[k][key])

        # per-tenant slices.  The split keys on qid (completion order is
        # whatever the scheduler produced — under "sla" qids complete far out
        # of submission order), so ``lat_by_qid`` must be a qid-indexed map,
        # never a positional zip against ``positions()``;
        # tests/test_torch_serving.py pins this against priority reordering.
        lat_by_qid = dict(zip(stats.latency_qids, stats.latencies))
        svc_by_qid = dict(zip(stats.latency_qids, stats.service_times))
        tenant_runs: list[TenantRun] = []
        for t, (h0, m0), r0, hb0 in zip(tenants, acc0, reads0, hbm0):
            pos = workload.positions(t.tid)
            t_results = [results[i] for i in pos]
            ts = WorkloadStats(n_queries=len(pos))
            ts.makespan_s = stats.makespan_s  # shared wall-clock
            ts.latencies = [lat_by_qid[i] for i in pos if i in lat_by_qid]
            ts.latency_qids = [i for i in pos if i in lat_by_qid]
            ts.sum_latency_s = float(sum(ts.latencies))
            ts.service_times = [svc_by_qid[i] for i in pos if i in svc_by_qid]
            ts.sum_service_s = float(sum(ts.service_times))
            ts.queue_wait_s = ts.sum_latency_s - ts.sum_service_s
            if sla_plan is not None and sla_plan.deadlines is not None:
                # a query met its SLA iff its arrival-relative latency fits
                # inside its deadline window (deadline - arrival)
                for i in ts.latency_qids:
                    win = float(
                        sla_plan.deadlines[i] - sla_plan.arrivals[i]
                    )
                    if lat_by_qid[i] <= win:
                        ts.deadline_hits += 1
                    else:
                        ts.deadline_misses += 1
                        ts.lateness_s += lat_by_qid[i] - win
            h1, m1 = t.accessor.stats()
            ts.cache_hits = h1 - h0
            ts.cache_misses = m1 - m0
            ts.io_count = t.accessor.reads - r0
            ts.io_bytes = ts.io_count * self.page_size
            if hb0 is not None:
                # per-tenant tier split from the view's own counters, as a
                # per-run delta (same idempotence rule as cache_hits)
                hv = t.accessor.hbm
                ts.hbm_hits = hv.hits - hb0[0]
                ts.hbm_misses = hv.misses - hb0[1]
            recall = None
            if t.spec.groundtruth is not None and len(pos):
                k = t.spec.groundtruth.shape[1]
                ids = np.full((len(pos), k), -1, dtype=np.int64)
                for row, r in enumerate(t_results):
                    m = min(k, len(r.ids))
                    ids[row, :m] = r.ids[:m]
                gt = t.spec.groundtruth[workload.query_ids[pos]]
                recall = recall_at_k(ids, gt, k)
            tenant_runs.append(TenantRun(
                name=t.name, tid=t.tid, results=t_results, stats=ts,
                recall=recall,
            ))
        return PlaneRun(results=results, stats=stats, tenants=tenant_runs)


def evaluate_plane(
    plane: ServingPlane,
    workload: MixedWorkload,
    ssd_config: SSDConfig | None = None,
) -> dict:
    """Run a mixed workload; return the serving-side metric dict (global
    throughput plus the per-tenant recall/QPS/p99/hit-rate split)."""
    run = plane.run(workload, ssd_config)
    s = run.stats
    served = s.hbm_hits + s.cache_hits
    accesses = served + s.cache_misses
    out = {
        "workload": workload.name,
        "n_ops": len(workload),
        "shared_pool": plane.pool is not None,
        "tenant_quota": plane.config.tenant_quota,
        "distance_backend": plane.dist.name,
        "combined_table": plane.table is not None,
        "scheduler": plane.config.scheduler,
        "sla_ms": plane.config.sla_ms,
        "qps": s.qps,
        "mean_latency_ms": s.mean_latency_ms,
        "p99_latency_ms": s.p99_latency_ms(),
        "mean_service_ms": s.mean_service_ms,
        "queue_wait_s": s.queue_wait_s,
        "deadline_hit_rate": s.deadline_hit_rate,
        "deadline_misses": s.deadline_misses,
        "hit_rate": s.hit_rate,
        "ios_per_query": s.ios_per_query,
        "lock_waits": s.lock_waits,
        "coalesced_record_loads": s.coalesced_record_loads,
        "quota_reclaims": s.quota_reclaims,
        "quota_denials": s.quota_denials,
        "score_flushes": s.score_flushes,
        "cross_tenant_flushes": s.cross_tenant_flushes,
        "overlap_flushes": s.overlap_flushes,
        "hbm_tier": plane.hbm is not None,
        "hbm_hits": s.hbm_hits,
        "hbm_hit_rate": s.hbm_hit_rate,
        "hbm_scatters": s.hbm_scatters,
        "combined_hit_rate": served / accesses if accesses else 0.0,
        "tenants": {},
    }
    for tr in run.tenants:
        out["tenants"][tr.name] = {
            "n_queries": tr.stats.n_queries,
            "recall@k": tr.recall,
            "qps": tr.stats.qps,
            "mean_latency_ms": tr.stats.mean_latency_ms,
            "p99_latency_ms": tr.stats.p99_latency_ms(),
            "mean_service_ms": tr.stats.mean_service_ms,
            "queue_wait_s": tr.stats.queue_wait_s,
            "deadline_hit_rate": tr.stats.deadline_hit_rate,
            "deadline_misses": tr.stats.deadline_misses,
            "hit_rate": tr.stats.hit_rate,
            "reads": tr.stats.io_count,
            "hbm_hits": tr.stats.hbm_hits,
            "hbm_hit_rate": tr.stats.hbm_hit_rate,
        }
    return out
