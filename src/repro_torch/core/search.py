"""Search algorithms as schedulable coroutines (paper §3.1, §4, Alg. 2).

Every algorithm is a Python generator — the host-plane analogue of a stackless
coroutine.  It yields engine ops and is resumed with their results:

    ("compute", seconds)                      -> None
    ("score", ScoreRequest)                   -> np.ndarray of distances
                                                 (may suspend: the engine can
                                                 park the request in its
                                                 cross-query rendezvous buffer)
    ("read", [pid, ...])                      -> {pid: page_bytes}   (suspends)
    ("load_wait", vid, pool)                  -> decoded record  (suspends:
                                                 parks on the record's LOCKED
                                                 buffer-pool slot until the
                                                 in-flight load publishes it;
                                                 None if the load was aborted)
    ("submit_cb", [pid, ...], callback)       -> None  (fire-and-forget prefetch;
                                                 callback(pid, bytes) runs at
                                                 completion time)
    ("submit", [pid, ...])                    -> [token, ...]  (non-blocking)
    ("wait_any", {token, ...})                -> (token, pid, page_bytes)

The same generator therefore runs unchanged under the synchronous executor
(B=1) and the asynchronous scheduler (B>1) — which is exactly the paper's
claim that the *algorithm* is orthogonal to the execution model, and is what
tests/test_engine.py asserts (async results == sync results).

Search coroutines never compute a distance themselves: every fresh-neighbor
frontier and every fetched record group is yielded to the engine as a
``("score", ScoreRequest)`` op carrying the prepared query and the rows to
evaluate — as VERTEX IDS on the quantized index (the engine owns the
register-once resident code tables and gathers the rows itself, on-device
for the torch backend; ``SearchContext.resident_ids=False`` materializes
the code matrices from the fetched payload bytes instead, the host-gather
parity path).  The engine executes the request through the pluggable
DistanceEngine (core.distance) — immediately when fusion is off (per-query
dispatch), or fused with the frontiers of the OTHER
coroutines in flight when fusion is on (one kernel dispatch serving many
queries; with the shared rendezvous, the coroutines of ALL workers).
tests/test_distance.py asserts exact id/hop/read parity across backends;
tests/test_fusion.py asserts parity between fused and per-query dispatch;
tests/test_resident.py asserts resident==host-gather and shared==per-worker
parity.
"""

from __future__ import annotations

import dataclasses
import math
from bisect import insort

import numpy as np

from repro_torch import tracing
from repro_torch.core import beam as beam_mod
from repro_torch.core import distance as distance_mod
from repro_torch.core import sharding as sharding_mod
from repro_torch.core.quant import RabitQuantizer
from repro_torch.core.sim import CostModel

# the record accessor's spans: record decode, and the pool's side of loading
# a page (slot acquisition, the clock sweep, evictions, publishing)
_DECODE = tracing.name("store.decode")
_ADMIT = tracing.name("pool.admit")


@dataclasses.dataclass
class SearchParams:
    k: int = 10
    L: int = 64          # candidate list size
    W: int = 4           # beam width / look-ahead set size
    cbs: bool = True     # cache-aware beam search (Alg. 2 pivot)
    prefetch: bool = True
    prefetch_depth: int = 4
    pipe_depth: int = 4  # PipeANN in-flight reads


@dataclasses.dataclass
class SearchContext:
    index: object               # VeloIndex | FixedIndex
    qb: object                  # QuantizedBase
    accessor: object            # RecordAccessor | PageAccessor
    cost: CostModel
    medoid: int
    base: np.ndarray | None = None  # only for the in-memory oracle engine
    # CPU charge for one record refinement: 4-bit dequant distance on the
    # compressed index, full fp32 distance on the DiskANN-style index.
    refine_cost_s: float = 0.0
    dist: object | None = None      # DistanceEngine; None -> process default
    # resident wire format: refine ScoreRequests carry vertex ids, resolved
    # against the engine's registered tables (False = host-gather semantics, the
    # coroutine materializes code matrices from the fetched payload bytes)
    resident_ids: bool = True
    # multi-tenant serving plane (core.serving): score requests are tagged
    # with the registered table their ids index and with the tenant id, and
    # id payloads are shifted into the plane's global vid namespace.  The
    # single-system defaults (own table, offset 0, tenant 0) leave the wire
    # format bitwise unchanged.
    table_qb: object | None = None  # table requests index (None -> qb)
    vid_base: int = 0               # offset into the combined-table rows
    tenant: int = 0                 # tenant tag on every score op
    # sharded scatter-gather plane (core.sharding): when set, score work is
    # yielded as ("scatter", ShardScatter) ops routing each row to the engine
    # shard that owns its record — the algorithm itself stays unchanged (the
    # default, None, keeps the single-engine ("score", ...) wire format)
    shard_plan: object | None = None
    # fused on-device beam step (core.beam): level-1 frontier maintenance
    # moves into ("beam", BeamRequest) ops whose reply is the next FRONTIER —
    # candidate heap and visited masks stay engine-resident across hops.  The
    # default (False) keeps the host _Beam path, which stays the bitwise
    # reference; True matches it result-bitwise (ids/dists/hops) per
    # tests/test_beam.py.
    device_beam: bool = False

    def __post_init__(self):
        if self.dist is None:
            self.dist = distance_mod.get_engine()
        if self.table_qb is None:
            self.table_qb = self.qb


@dataclasses.dataclass
class QueryResult:
    ids: np.ndarray
    dists: np.ndarray
    hops: int
    reads: int


# ------------------------------------------------------------------ accessors


class RecordAccessor:
    """Record-level buffer pool access path (paper §3.2): on miss, read the
    page, decode ONLY the needed record (plus same-Color co-residents, §3.4),
    admit them, discard the rest of the page.

    With ``async_load=True`` (the default) misses open a real LOCKED window:
    the slot is reserved via ``pool.begin_load`` BEFORE the page read is
    issued and published via ``pool.finish_load`` when it completes, so every
    concurrent searcher of the same record — on any worker — parks on the
    slot (engine ``load_wait`` op) instead of re-reading the page; co-resident
    records are installed as one ``admit_group``.  ``async_load=False``
    reproduces the legacy per-record synchronous admits (kept for the
    determinism/parity tests and as the pre-shared-pool baseline).

    ``hbm`` (``core.hbm.HbmTier`` / ``HbmView``, default None == off) inserts
    the HBM record-cache tier ABOVE the pool: lookups consult the tier first
    (a tier hit touches neither the pool nor the SSD), tier misses fall
    through to the pool unchanged, and a pool hit on a record the tier does
    not hold promotes it (``note_hit``) for the next dispatch-boundary
    scatter.  The pool's miss path is untouched — its ``on_publish`` hook,
    not the accessor, stages freshly loaded records."""

    def __init__(self, index, pool, cost: CostModel, co_admit: bool = True,
                 track_access: bool = False, async_load: bool = True,
                 hbm=None):
        self.index = index
        self.pool = pool
        self.cost = cost
        self.co_admit = co_admit
        self.async_load = async_load
        self.hbm = hbm
        self.reads = 0
        # per-vertex / per-page access counters (Fig. 4 skew study)
        self.track_access = track_access
        if track_access:
            import numpy as _np
            self.vertex_counts = _np.zeros(index.n, dtype=_np.int64)
            self.page_counts = _np.zeros(index.store.n_pages, dtype=_np.int64)

    def _track(self, vid: int) -> None:
        if self.track_access:
            self.vertex_counts[vid] += 1
            self.page_counts[self.index.page_of(vid)] += 1

    def resident(self, vid: int) -> bool:
        # Alg. 2's InMemory(): a LOCKED slot is NOT in memory — pivoting to
        # it would block on the in-flight load instead of avoiding an I/O.
        # A record installed in an HBM cache slot is as in-memory as it gets.
        if self.hbm is not None and self.hbm.ready(vid):
            return True
        return self.pool.peek_present(vid)

    def _admit_from_page(self, vid: int, page: bytes):
        sp = tracing.begin(_DECODE) if tracing.on else -1
        rec = self.index.decode_record(vid, page)
        if sp >= 0:
            tracing.end(sp)
            sp = tracing.begin(_ADMIT)
        self.pool.admit(vid, rec)
        if sp >= 0:
            tracing.end(sp)
        if self.co_admit:
            sp = tracing.begin(_DECODE) if tracing.on else -1
            extras = self.index.co_resident_records(vid, page)
            if sp >= 0:
                tracing.end(sp)
                sp = tracing.begin(_ADMIT)
            for extra in extras:
                self.pool.admit(extra.vid, extra)
            if sp >= 0:
                tracing.end(sp)
        return rec

    def _publish_from_page(self, vid: int, page: bytes):
        """Close vid's LOCKED window with the decoded record and install its
        co-resident group under one clock interaction."""
        sp = tracing.begin(_DECODE) if tracing.on else -1
        rec = self.index.decode_record(vid, page)
        if sp >= 0:
            tracing.end(sp)
            sp = tracing.begin(_ADMIT)
        self.pool.finish_load(vid, rec)
        if sp >= 0:
            tracing.end(sp)
        if self.co_admit:
            sp = tracing.begin(_DECODE) if tracing.on else -1
            extras = self.index.co_resident_records(vid, page)
            if sp >= 0:
                tracing.end(sp)
                sp = tracing.begin(_ADMIT) if extras else -1
            if extras:
                self.pool.admit_group([e.vid for e in extras], extras)
            if sp >= 0:
                tracing.end(sp)
        return rec

    def _demand_load(self, vid: int):
        """Demand-read vid's page and publish (or sync-admit) its record.
        The access was already counted/tracked by the caller."""
        sp = tracing.begin(_ADMIT) if tracing.on else -1
        slot = self.pool.begin_load(vid) if self.async_load else -1
        if sp >= 0:
            tracing.end(sp)
        pid = self.index.page_of(vid)
        pages = yield ("read", [pid])
        self.reads += 1
        yield ("compute", self.cost.page_parse_s + self.cost.record_decode_s)
        if slot >= 0:
            return self._publish_from_page(vid, pages[pid])
        # legacy path, or pool exhausted (every slot LOCKED): sync admit
        return self._admit_from_page(vid, pages[pid])

    def get(self, vid: int):
        self._track(vid)
        if self.hbm is not None:
            rec = self.hbm.lookup(vid)
            if rec is not None:
                return rec  # tier hit: pool and SSD untouched
        rec = self.pool.lookup(vid)
        if rec is not None:
            if self.hbm is not None:
                self.hbm.note_hit(vid, rec)  # proven hot: promote to the tier
            return rec
        if self.async_load:
            while self.pool.is_loading(vid):
                # coalesce on the in-flight load instead of re-reading
                rec = yield ("load_wait", vid, self.pool)
                if rec is not None:
                    return rec
                # load aborted: fall through and issue our own
        return (yield from self._demand_load(vid))

    def get_many(self, vids: list[int]):
        out: dict[int, object] = {}
        missing: list[int] = []
        loading: list[int] = []
        for v in vids:
            self._track(v)
            if self.hbm is not None:
                rec = self.hbm.lookup(v)
                if rec is not None:
                    out[v] = rec  # tier hit: pool and SSD untouched
                    continue
            rec = self.pool.lookup(v)
            if rec is not None:
                out[v] = rec
                if self.hbm is not None:
                    self.hbm.note_hit(v, rec)
            elif self.async_load and self.pool.is_loading(v):
                loading.append(v)
            else:
                missing.append(v)
        if missing:
            pids = sorted({self.index.page_of(v) for v in missing})
            sp = tracing.begin(_ADMIT) if tracing.on else -1
            slots = (
                {v: self.pool.begin_load(v) for v in missing}
                if self.async_load else {}
            )
            if sp >= 0:
                tracing.end(sp)
            pages = yield ("read", pids)
            self.reads += len(pids)
            yield (
                "compute",
                len(pids) * self.cost.page_parse_s
                + len(missing) * self.cost.record_decode_s,
            )
            for v in missing:
                page = pages[self.index.page_of(v)]
                if slots.get(v, -1) >= 0:
                    out[v] = self._publish_from_page(v, page)
                else:
                    out[v] = self._admit_from_page(v, page)
        # park on other coroutines' in-flight loads LAST: our own loads are
        # already published, so the loaders we wait on can never be waiting
        # on us (no cross-coroutine deadlock)
        for v in loading:
            rec = yield ("load_wait", v, self.pool)
            while rec is None:  # window closed empty (abort, or published
                # then evicted before we were scheduled): load it ourselves —
                # WITHOUT re-tracking the access, which was already counted
                if self.pool.is_loading(v):
                    rec = yield ("load_wait", v, self.pool)
                else:
                    rec = yield from self._demand_load(v)
            out[v] = rec
        return out

    def install(self, vid: int, pid: int, page: bytes):
        """Decode vid's record from an already-fetched page and admit it —
        the accessor-owned install path for algorithms that drive their own
        reads (PipeANN's relaxed-ordering completions).  Keeping the pool
        interaction here, not in the coroutine, is the layering rule:
        coroutines yield ops and call
        accessors; only accessors touch the pool."""
        sp = tracing.begin(_DECODE) if tracing.on else -1
        rec = self.index.decode_record(vid, page)
        if sp >= 0:
            tracing.end(sp)
            sp = tracing.begin(_ADMIT)
        self.pool.admit(vid, rec)
        if sp >= 0:
            tracing.end(sp)
        return rec

    def prefetch_op(self, vid: int):
        """Return a fire-and-forget op loading vid's record, or None if the
        record is already present or its load is already in flight."""
        if self.hbm is not None and self.hbm.ready(vid):
            return None  # already served from an HBM slot: nothing to load
        if self.pool.peek_resident(vid):
            return None
        pid = self.index.page_of(vid)

        if self.async_load:
            sp = tracing.begin(_ADMIT) if tracing.on else -1
            slot = self.pool.begin_load(vid)
            if sp >= 0:
                tracing.end(sp)
            if slot >= 0:
                def on_publish(_pid: int, page: bytes) -> None:
                    self._publish_from_page(vid, page)

                return ("submit_cb", [pid], on_publish)
            # every slot LOCKED: fall back to the uncached legacy prefetch

        def on_complete(_pid: int, page: bytes) -> None:
            if not self.pool.peek_resident(vid):
                self._admit_from_page(vid, page)

        return ("submit_cb", [pid], on_complete)

    def stats(self) -> tuple[int, int]:
        return self.pool.hits, self.pool.misses


class PageAccessor:
    """Page-level cache access path (DiskANN/Starling/PipeANN baselines and the
    '+Record'-ablated VeloANN variant): whole pages are cached; records are
    re-parsed out of the cached page on every access."""

    def __init__(self, index, cache, cost: CostModel, track_access: bool = False):
        self.index = index
        self.cache = cache
        self.cost = cost
        self.reads = 0
        self.track_access = track_access
        if track_access:
            import numpy as _np
            self.vertex_counts = _np.zeros(index.n, dtype=_np.int64)
            self.page_counts = _np.zeros(index.store.n_pages, dtype=_np.int64)

    def _track(self, vid: int) -> None:
        if self.track_access:
            self.vertex_counts[vid] += 1
            self.page_counts[self.index.page_of(vid)] += 1

    def resident(self, vid: int) -> bool:
        return self.cache.contains(self.index.page_of(vid))

    def get(self, vid: int):
        self._track(vid)
        pid = self.index.page_of(vid)
        page = self.cache.lookup(pid)
        if page is None:
            pages = yield ("read", [pid])
            self.reads += 1
            page = pages[pid]
            self.cache.admit(pid, page)
        yield ("compute", self.cost.page_parse_s + self.cost.record_decode_s)
        return self.index.decode_record(vid, page)

    def get_many(self, vids: list[int]):
        out: dict[int, object] = {}
        have: dict[int, bytes] = {}   # pid -> bytes, pinned locally for this step
        vid_page: dict[int, int] = {}
        for v in vids:
            self._track(v)
            pid = self.index.page_of(v)
            vid_page[v] = pid
            if pid not in have:
                page = self.cache.lookup(pid)
                if page is not None:
                    have[pid] = page
        missing_pids = sorted({p for p in vid_page.values() if p not in have})
        if missing_pids:
            got = yield ("read", missing_pids)
            self.reads += len(missing_pids)
            for pid, page in got.items():
                self.cache.admit(pid, page)
                have[pid] = page
        yield (
            "compute",
            len(vids) * (self.cost.page_parse_s + self.cost.record_decode_s),
        )
        for v in vids:
            out[v] = self.index.decode_record(v, have[vid_page[v]])
        return out

    def install(self, vid: int, pid: int, page: bytes):
        """Admit an already-fetched page and decode vid's record out of it —
        the page-granular twin of ``RecordAccessor.install`` (same contract:
        the coroutine hands the bytes over; the accessor owns the cache)."""
        self.cache.admit(pid, page)
        return self.index.decode_record(vid, page)

    def prefetch_op(self, vid: int):
        pid = self.index.page_of(vid)
        if self.cache.contains(pid):
            return None

        def on_complete(_pid: int, page: bytes) -> None:
            self.cache.admit(pid, page)

        return ("submit_cb", [pid], on_complete)

    def stats(self) -> tuple[int, int]:
        return self.cache.hits, self.cache.misses


# ------------------------------------------------------------------- helpers


class _Beam:
    """Sorted candidate list P with explored/seen tracking (bounded size L)."""

    def __init__(self, L: int):
        self.L = L
        self.items: list[tuple[float, int]] = []  # (est_d2, vid), sorted
        self.seen: set[int] = set()
        self.explored: set[int] = set()

    def insert(self, vid: int, est: float) -> None:
        if vid in self.seen:
            return
        self.seen.add(vid)
        insort(self.items, (est, vid))
        if len(self.items) > 4 * self.L:
            self.items = self.items[: 2 * self.L]

    def window(self) -> list[tuple[float, int]]:
        return self.items[: self.L]

    def unexplored(self, limit: int | None = None) -> list[int]:
        out = []
        for _, v in self.window():
            if v not in self.explored:
                out.append(v)
                if limit is not None and len(out) >= limit:
                    break
        return out

    def mark(self, vid: int) -> None:
        self.explored.add(vid)


def _query_prep_cost(cost: CostModel, d: int) -> float:
    # rotation via fast transform ~ d log d flops
    return d * max(1.0, math.log2(d)) * 1e-9


def _finish(refined: dict[int, float], k: int) -> tuple[np.ndarray, np.ndarray]:
    items = sorted(refined.items(), key=lambda kv: (kv[1], kv[0]))[:k]
    ids = np.asarray([v for v, _ in items], dtype=np.int64)
    ds = np.asarray([dv for _, dv in items], dtype=np.float32)
    return ids, ds


def _fresh_union(beam: "_Beam", recs: list) -> list[int]:
    """Unseen neighbors of a record group, deduped, first-occurrence order."""
    fresh: list[int] = []
    local: set[int] = set()
    for rec in recs:
        for u in rec.adjacency:
            u = int(u)
            if u not in beam.seen and u not in local:
                local.add(u)
                fresh.append(u)
    return fresh


def _dispatch_score(ctx: SearchContext, req, vids):
    """Yield one score op through the active dispatch plane: the single
    engine ("score"), or — when ``ctx.shard_plan`` is set — the sharded
    scatter-gather plane ("scatter"), routing each row to the engine shard
    owning its record.  ``vids`` are the LOCAL vertex ids of the request's
    rows, in row order (routing is computed before any serving-plane
    ``vid_base`` shift, so it is independent of the table namespace)."""
    if ctx.shard_plan is None:
        out = yield ("score", req)
        return out
    scatter = sharding_mod.ShardScatter(
        req=req, shard_rows=ctx.shard_plan.shards_of(vids)
    )
    out = yield ("scatter", scatter)
    return out


def _estimate_scores(ctx: SearchContext, pq, ids: list[int]):
    """Yield one level-1 score op for ``ids``; returns the estimate array.
    The engine charges the batch's flops plus an amortized dispatch — shared
    with other queries' frontiers when cross-query fusion is on."""
    payload = np.asarray(ids, dtype=np.int64)
    if ctx.vid_base:
        payload = payload + ctx.vid_base  # rows in the combined serving table
    req = distance_mod.ScoreRequest(
        kind="estimate",
        rows=len(ids),
        flop_s=ctx.cost.estimate(len(ids), ctx.qb.dim),
        pq=pq,
        payload=payload,
        qb=ctx.table_qb,
        tenant=ctx.tenant,
    )
    ests = yield from _dispatch_score(ctx, req, ids)
    return ests


def _refine_records(ctx: SearchContext, pq, recs: list):
    """Yield one level-2/fp32 score op refining a fetched record group;
    returns the refined distance array (one per record, in order).  On the
    quantized index the request carries only vertex ids (the engine owns the
    resident level-2 table) unless ``ctx.resident_ids`` is off."""
    kind, payload = ctx.index.refine_payload(recs, resident=ctx.resident_ids)
    if kind == "refine" and ctx.vid_base and not isinstance(payload, tuple):
        payload = payload + ctx.vid_base  # rows in the combined serving table
    req = distance_mod.ScoreRequest(
        kind=kind,
        rows=len(recs),
        flop_s=len(recs) * ctx.refine_cost_s,
        pq=pq,
        payload=payload,
        query=pq.q_orig if kind == "full" else None,
        qb=ctx.table_qb if kind != "full" else None,
        tenant=ctx.tenant,
    )
    dists = yield from _dispatch_score(ctx, req, [r.vid for r in recs])
    return dists


def _score_into_beam(ctx: SearchContext, pq, beam: "_Beam", fresh: list[int]):
    """One batched level-1 evaluation of a fresh frontier, inserted into the
    beam.  (Generator: the engine executes — and may fuse — the score op.)"""
    if not fresh:
        return
    ests = yield from _estimate_scores(ctx, pq, fresh)
    for u, e in zip(fresh, ests):
        beam.insert(u, float(e))


# ------------------------------------------------------ device-resident beam


def _dispatch_beam(ctx: SearchContext, req, vids):
    """Yield one fused beam op through the active dispatch plane: the single
    engine ("beam"), or — when ``ctx.shard_plan`` is set — the scatter plane,
    each owning shard scoring its slice of the fresh frontier and the join
    merging the local top-Ls before frontier selection.  ``vids`` are the
    LOCAL fresh ids in row order (like ``_dispatch_score``)."""
    if ctx.shard_plan is None:
        out = yield ("beam", req)
        return out
    scatter = sharding_mod.ShardScatter(
        req=req, shard_rows=ctx.shard_plan.shards_of(vids)
    )
    out = yield ("scatter", scatter)
    return out


class _DeviceBeam:
    """Host-side mirror of one query's engine-resident beam state.

    The heap and visited/explored masks live with the DistanceEngine
    (``ctx.dist.beam_new``, device tensors on torch); the coroutine keeps
    only what it needs between hops without a download: the ``seen`` /
    ``explored`` sets (cheap host bookkeeping, also used by
    ``_fresh_union``), the last reply's frontier / window stats, and the
    pending explored-marks and known-distance inserts that ride along with
    the next ``("beam", ...)`` op.  ``step`` is the one generator that talks
    to the engine — one op per hop, whose reply is the next frontier."""

    def __init__(self, ctx: SearchContext, pq, L: int,
                 kind: str = "estimate", query=None):
        self.ctx = ctx
        self.pq = pq
        self.L = L
        self.kind = kind
        self.query = query
        self.state = ctx.dist.beam_new(L, ctx.index.n)
        self.seen: set[int] = set()
        self.explored: set[int] = set()
        self.window_len = 0
        self.tail = float("inf")
        self.topk: tuple[np.ndarray, np.ndarray] | None = None
        self._frontier: list[int] = []
        self._marks: list[int] = []
        self._ins_v: list[int] = []
        self._ins_d: list[float] = []

    def insert(self, vid: int, dist: float) -> bool:
        """Queue a known-distance insert for the next step (first-wins, the
        host ``_Beam.insert`` early-return on seen ids)."""
        if vid in self.seen:
            return False
        self.seen.add(vid)
        self._ins_v.append(int(vid))
        self._ins_d.append(float(dist))
        return True

    def mark(self, vid: int) -> None:
        """Mark explored: applied to the cached frontier immediately, to the
        device mask with the next step's op."""
        self.explored.add(vid)
        self._marks.append(int(vid))
        try:
            self._frontier.remove(vid)
        except ValueError:
            pass

    def unexplored(self, limit: int | None = None) -> list[int]:
        if limit is not None:
            return self._frontier[:limit]
        return list(self._frontier)

    def pending(self) -> bool:
        """True when queued inserts could change the window/frontier (marks
        alone keep the cached frontier exact and can wait for the next op)."""
        return bool(self._ins_v)

    def step(self, fresh: list[int], topk: int = 0):
        """One fused beam step: score ``fresh``, fold in pending inserts and
        marks, merge, and refresh the cached frontier/window from the reply
        — the ONE exchange of this hop."""
        ctx = self.ctx
        for u in fresh:
            self.seen.add(int(u))
        fresh_arr = np.asarray(fresh, dtype=np.int64)
        if self.kind == "full":
            vectors = ctx.base[fresh_arr]
            flop_s = fresh_arr.size * ctx.cost.refine_full(ctx.base.shape[1])
            qb = None
            query = np.asarray(self.query, dtype=np.float32)
        else:
            vectors = None
            flop_s = ctx.cost.estimate(int(fresh_arr.size), ctx.qb.dim)
            qb = ctx.table_qb
            query = None
        req = beam_mod.BeamRequest(
            kind=self.kind,
            state=self.state,
            fresh=fresh_arr,
            explored=np.asarray(self._marks, dtype=np.int64),
            insert_ids=np.asarray(self._ins_v, dtype=np.int64),
            insert_ds=np.asarray(self._ins_d, dtype=np.float32),
            rows=int(fresh_arr.size),
            flop_s=flop_s,
            pq=self.pq,
            query=query,
            vectors=vectors,
            qb=qb,
            tenant=ctx.tenant,
            topk=int(topk),
            vid_base=ctx.vid_base,
        )
        self._marks, self._ins_v, self._ins_d = [], [], []
        res = yield from _dispatch_beam(ctx, req, [int(u) for u in fresh])
        self._frontier = [int(u) for u in res.frontier]
        self.window_len = int(res.window_len)
        self.tail = float(res.tail)
        if topk:
            self.topk = (
                np.asarray(res.topk_ids, dtype=np.int64),
                np.asarray(res.topk_ds, dtype=np.float32),
            )
        return res


# ----------------------------------------------------------- VeloANN (Alg. 2)


def velo_search(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """Cache-aware beam search with proactive prefetching (paper Alg. 2)."""
    if ctx.device_beam:
        return (yield from _velo_search_device(ctx, q, p))
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    beam = _Beam(p.L)
    est0 = float((yield from _estimate_scores(ctx, pq, [ctx.medoid]))[0])
    beam.insert(ctx.medoid, est0)

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads
    prefetched: set[int] = set()  # avoid re-submitting in-flight prefetches

    while True:
        unexp = beam.unexplored(limit=p.W)
        if not unexp:
            break
        v = unexp[0]  # top-1 nearest unexplored (Alg. 2 line 5)

        if p.cbs and not acc.resident(v):
            # Alg. 2 lines 8-14: pivot to the first in-memory candidate in the
            # look-ahead set C; prefetch on-disk members of C.
            pivot = None
            for c in unexp:
                if pivot is None and acc.resident(c):
                    pivot = c
                elif p.prefetch and c not in prefetched:
                    op = acc.prefetch_op(c)
                    if op is not None:
                        prefetched.add(c)
                        yield ("compute", cost.io_submit_s)
                        yield op
            if pivot is not None:
                v = pivot
        elif p.prefetch:
            # §4.1 stride prefetch of the top-B frontier candidates
            for c in unexp[1 : 1 + p.prefetch_depth]:
                if c in prefetched:
                    continue
                op = acc.prefetch_op(c)
                if op is not None:
                    prefetched.add(c)
                    yield ("compute", cost.io_submit_s)
                    yield op

        rec = yield from acc.get(v)  # suspends on miss (Alg. 2 line 17)
        yield ("compute", cost.visit_overhead_s)
        refined[v] = float((yield from _refine_records(ctx, pq, [rec]))[0])
        beam.mark(v)
        hops += 1

        yield from _score_into_beam(ctx, pq, beam, _fresh_union(beam, [rec]))

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


def _velo_search_device(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """Alg. 2 with the beam engine-resident: the pivot/prefetch policy and
    the refine path are the host loop's, but level-1 frontier maintenance is
    one ("beam", ...) op per hop whose reply is the next frontier — no
    estimate download, and only ``beam_visit_s`` of host bookkeeping per
    explored vertex (result-bitwise the host path; op schedule differs)."""
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    bm = _DeviceBeam(ctx, pq, p.L)
    yield from bm.step([ctx.medoid])  # seed: medoid scored inside the step

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads
    prefetched: set[int] = set()

    while True:
        unexp = bm.unexplored(limit=p.W)
        if not unexp:
            break
        v = unexp[0]

        if p.cbs and not acc.resident(v):
            pivot = None
            for c in unexp:
                if pivot is None and acc.resident(c):
                    pivot = c
                elif p.prefetch and c not in prefetched:
                    op = acc.prefetch_op(c)
                    if op is not None:
                        prefetched.add(c)
                        yield ("compute", cost.io_submit_s)
                        yield op
            if pivot is not None:
                v = pivot
        elif p.prefetch:
            for c in unexp[1 : 1 + p.prefetch_depth]:
                if c in prefetched:
                    continue
                op = acc.prefetch_op(c)
                if op is not None:
                    prefetched.add(c)
                    yield ("compute", cost.io_submit_s)
                    yield op

        rec = yield from acc.get(v)
        yield ("compute", cost.beam_visit_s)
        refined[v] = float((yield from _refine_records(ctx, pq, [rec]))[0])
        bm.mark(v)
        hops += 1

        fresh = _fresh_union(bm, [rec])
        if fresh:
            yield from bm.step(fresh)

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


# ------------------------------------------------- DiskANN-style beam search


def diskann_search(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """Synchronous beam search [23]: at each step fetch the top-W unexplored
    candidates with one batched read (bottlenecked by the slowest read)."""
    if ctx.device_beam:
        return (yield from _diskann_search_device(ctx, q, p))
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    beam = _Beam(p.L)
    est0 = float((yield from _estimate_scores(ctx, pq, [ctx.medoid]))[0])
    beam.insert(ctx.medoid, est0)

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads

    while True:
        batch = beam.unexplored(limit=max(1, p.W))
        if not batch:
            break
        recs = yield from acc.get_many(batch)
        rec_list = [recs[v] for v in batch]
        # refine the whole fetched record group in one engine call
        yield ("compute", len(batch) * cost.visit_overhead_s)
        dists = yield from _refine_records(ctx, pq, rec_list)
        for v, dv in zip(batch, dists):
            refined[v] = float(dv)
            beam.mark(v)
            hops += 1
        # one batched level-1 scan over the union of fresh neighbors
        yield from _score_into_beam(ctx, pq, beam, _fresh_union(beam, rec_list))

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


def _diskann_search_device(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """DiskANN beam with engine-resident frontier selection: one beam op per
    batch expansion instead of an estimate download per hop group."""
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    bm = _DeviceBeam(ctx, pq, p.L)
    yield from bm.step([ctx.medoid])

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads

    while True:
        batch = bm.unexplored(limit=max(1, p.W))
        if not batch:
            break
        recs = yield from acc.get_many(batch)
        rec_list = [recs[v] for v in batch]
        yield ("compute", len(batch) * cost.beam_visit_s)
        dists = yield from _refine_records(ctx, pq, rec_list)
        for v, dv in zip(batch, dists):
            refined[v] = float(dv)
            bm.mark(v)
            hops += 1
        fresh = _fresh_union(bm, rec_list)
        if fresh:
            yield from bm.step(fresh)

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


# ------------------------------------------------ Starling-style block search


def starling_search(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """DiskANN beam + block search: every fetched page's co-resident records
    are refined and expanded for free (exploits the shuffled layout)."""
    if ctx.device_beam:
        return (yield from _starling_search_device(ctx, q, p))
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    index = ctx.index
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    beam = _Beam(p.L)
    est0 = float((yield from _estimate_scores(ctx, pq, [ctx.medoid]))[0])
    beam.insert(ctx.medoid, est0)

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads

    while True:
        batch = beam.unexplored(limit=max(1, p.W))
        if not batch:
            break
        recs = yield from acc.get_many(batch)
        extra_vids: list[int] = []
        extra_set: set[int] = set()
        for v in batch:
            pid = index.page_of(v)
            for u in index.page_record_ids(pid):
                if u not in beam.explored and u not in batch and u not in extra_set:
                    extra_set.add(u)
                    extra_vids.append(u)
        extra_recs: dict[int, object] = {}
        if extra_vids:
            # co-resident records: their pages are cached by the batch fetch,
            # so this decodes in place — no new I/O
            extra_recs = yield from acc.get_many(extra_vids)
        group = batch + extra_vids
        rec_list = [recs[v] if v in recs else extra_recs[v] for v in group]
        # refine batch members + co-residents in one engine call …
        yield ("compute", len(group) * cost.visit_overhead_s)
        dists = yield from _refine_records(ctx, pq, rec_list)
        # … then apply the block-search admission filter sequentially: whether
        # a co-resident enters depends on the window as of its turn
        for v, rec, dv in zip(group, rec_list, dists):
            if v in beam.explored:
                continue
            dist = float(dv)
            if v in extra_set:
                window = beam.window()
                if window and len(window) >= p.L and dist >= window[-1][0]:
                    continue
            refined[v] = dist
            beam.mark(v)
            beam.insert(v, dist)
            hops += 1
            yield from _score_into_beam(ctx, pq, beam, _fresh_union(beam, [rec]))

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


def _starling_search_device(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """Block search with the beam engine-resident.  The sequential admission
    filter needs the window AS OF each co-resident's turn, so every admitted
    record's step ships immediately (pending insert forces it even when the
    record expands no fresh neighbors) and the cached ``window_len``/``tail``
    mirror the host's ``beam.window()`` check exactly."""
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    index = ctx.index
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    bm = _DeviceBeam(ctx, pq, p.L)
    yield from bm.step([ctx.medoid])

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads

    while True:
        batch = bm.unexplored(limit=max(1, p.W))
        if not batch:
            break
        recs = yield from acc.get_many(batch)
        extra_vids: list[int] = []
        extra_set: set[int] = set()
        for v in batch:
            pid = index.page_of(v)
            for u in index.page_record_ids(pid):
                if u not in bm.explored and u not in batch and u not in extra_set:
                    extra_set.add(u)
                    extra_vids.append(u)
        extra_recs: dict[int, object] = {}
        if extra_vids:
            extra_recs = yield from acc.get_many(extra_vids)
        group = batch + extra_vids
        rec_list = [recs[v] if v in recs else extra_recs[v] for v in group]
        yield ("compute", len(group) * cost.beam_visit_s)
        dists = yield from _refine_records(ctx, pq, rec_list)
        for v, rec, dv in zip(group, rec_list, dists):
            if v in bm.explored:
                continue
            dist = float(dv)
            if v in extra_set and bm.window_len >= p.L and dist >= bm.tail:
                continue
            refined[v] = dist
            bm.mark(v)
            bm.insert(v, dist)
            hops += 1
            fresh = _fresh_union(bm, [rec])
            if fresh or bm.pending():
                yield from bm.step(fresh)

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


# -------------------------------------------------- PipeANN-style pipelining


def pipeann_search(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """Pipelined best-first search [15]: keep up to `pipe_depth` reads in
    flight and process completions in arrival order (relaxed ordering) —
    lower latency, some wasted I/O."""
    if ctx.device_beam:
        return (yield from _pipeann_search_device(ctx, q, p))
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    index = ctx.index
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    beam = _Beam(p.L)
    est0 = float((yield from _estimate_scores(ctx, pq, [ctx.medoid]))[0])
    beam.insert(ctx.medoid, est0)

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads
    outstanding: dict[int, int] = {}  # token -> vid
    inflight: set[int] = set()

    def process(v, rec):
        """Refine + expand one arrived record (generator: scores via engine)."""
        nonlocal hops
        refined[v] = float((yield from _refine_records(ctx, pq, [rec]))[0])
        beam.mark(v)
        hops += 1
        yield from _score_into_beam(ctx, pq, beam, _fresh_union(beam, [rec]))

    while True:
        # fill the pipeline with the best unexplored, uninflight candidates
        cands = [v for v in beam.unexplored() if v not in inflight]
        while len(outstanding) < p.pipe_depth and cands:
            v = cands.pop(0)
            if acc.resident(v):
                rec = yield from acc.get(v)
                yield ("compute", cost.visit_overhead_s)
                yield from process(v, rec)
                cands = [x for x in beam.unexplored() if x not in inflight]
                continue
            pid = index.page_of(v)
            yield ("compute", cost.io_submit_s)
            tokens = yield ("submit", [pid])
            outstanding[tokens[0]] = v
            inflight.add(v)

        if not outstanding:
            if not beam.unexplored():
                break
            continue

        token, pid, page = yield ("wait_any", set(outstanding))
        v = outstanding.pop(token)
        inflight.discard(v)
        acc.reads += 1
        yield ("compute", cost.page_parse_s + cost.record_decode_s)
        rec = acc.install(v, pid, page)
        if v in beam.explored:
            continue  # over-fetched: candidate already pruned/processed
        yield ("compute", cost.visit_overhead_s)
        yield from process(v, rec)

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


def _pipeann_search_device(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """Pipelined search with engine-resident frontier selection: arrivals
    refine through the normal path, expansion is one beam op per record."""
    cost, qb, acc = ctx.cost, ctx.qb, ctx.accessor
    index = ctx.index
    d = qb.dim
    yield ("compute", _query_prep_cost(cost, d))
    pq = RabitQuantizer.prepare_query(qb, q)

    bm = _DeviceBeam(ctx, pq, p.L)
    yield from bm.step([ctx.medoid])

    refined: dict[int, float] = {}
    hops = 0
    reads0 = acc.reads
    outstanding: dict[int, int] = {}  # token -> vid
    inflight: set[int] = set()

    def process(v, rec):
        nonlocal hops
        refined[v] = float((yield from _refine_records(ctx, pq, [rec]))[0])
        bm.mark(v)
        hops += 1
        fresh = _fresh_union(bm, [rec])
        if fresh:
            yield from bm.step(fresh)

    while True:
        cands = [v for v in bm.unexplored() if v not in inflight]
        while len(outstanding) < p.pipe_depth and cands:
            v = cands.pop(0)
            if acc.resident(v):
                rec = yield from acc.get(v)
                yield ("compute", cost.beam_visit_s)
                yield from process(v, rec)
                cands = [x for x in bm.unexplored() if x not in inflight]
                continue
            pid = index.page_of(v)
            yield ("compute", cost.io_submit_s)
            tokens = yield ("submit", [pid])
            outstanding[tokens[0]] = v
            inflight.add(v)

        if not outstanding:
            if not bm.unexplored():
                break
            continue

        token, pid, page = yield ("wait_any", set(outstanding))
        v = outstanding.pop(token)
        inflight.discard(v)
        acc.reads += 1
        yield ("compute", cost.page_parse_s + cost.record_decode_s)
        rec = acc.install(v, pid, page)
        if v in bm.explored:
            continue  # over-fetched: candidate already pruned/processed
        yield ("compute", cost.beam_visit_s)
        yield from process(v, rec)

    ids, ds = _finish(refined, p.k)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=acc.reads - reads0)


# -------------------------------------------------------- in-memory Vamana


def inmemory_search(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """Fully in-memory Vamana greedy beam search — the paper's Fig. 1/12
    reference point.  Exact fp32 distances, no I/O ever."""
    if ctx.device_beam:
        return (yield from _inmemory_search_device(ctx, q, p))
    assert ctx.base is not None
    cost = ctx.cost
    base = ctx.base
    d = base.shape[1]
    graph = ctx.index.graph

    def full_scores(vids: list[int]):
        vectors = base[np.asarray(vids)]
        req = distance_mod.ScoreRequest(
            kind="full",
            rows=vectors.shape[0],
            flop_s=vectors.shape[0] * cost.refine_full(d),
            payload=vectors,
            query=np.asarray(q, dtype=np.float32),
            tenant=ctx.tenant,
        )
        out = yield from _dispatch_score(ctx, req, vids)
        return out

    beam = _Beam(p.L)
    beam.insert(
        ctx.medoid, float((yield from full_scores([ctx.medoid]))[0])
    )
    hops = 0
    while True:
        unexp = beam.unexplored(limit=1)
        if not unexp:
            break
        v = unexp[0]
        beam.mark(v)
        hops += 1
        nbrs = [int(u) for u in graph.neighbors(v) if int(u) not in beam.seen]
        if nbrs:
            yield ("compute", cost.visit_overhead_s)
            d2 = yield from full_scores(nbrs)
            for u, e in zip(nbrs, d2):
                beam.insert(u, float(e))

    # every beam entry carries an exact distance here
    topk = beam.items[: p.k]
    ids = np.asarray([v for _, v in topk], dtype=np.int64)
    ds = np.asarray([e for e, _ in topk], dtype=np.float32)
    return QueryResult(ids=ids, dists=ds, hops=hops, reads=0)


def _inmemory_search_device(ctx: SearchContext, q: np.ndarray, p: SearchParams):
    """In-memory greedy search with the fp32 (kind="full") beam step: every
    hop ships the expanded neighbors' raw vectors once and reads back only
    the frontier; ``topk=p.k`` keeps the heap head downloaded so the final
    answer needs no extra exchange (marks never change the heap, so the last
    step's readout is already final)."""
    assert ctx.base is not None
    cost = ctx.cost
    graph = ctx.index.graph

    bm = _DeviceBeam(ctx, None, p.L, kind="full", query=q)
    yield from bm.step([ctx.medoid], topk=p.k)
    hops = 0
    while True:
        unexp = bm.unexplored(limit=1)
        if not unexp:
            break
        v = unexp[0]
        bm.mark(v)
        hops += 1
        nbrs = [int(u) for u in graph.neighbors(v) if int(u) not in bm.seen]
        if nbrs:
            yield ("compute", cost.beam_visit_s)
            yield from bm.step(nbrs, topk=p.k)

    ids, ds = bm.topk
    return QueryResult(ids=ids[: p.k], dists=ds[: p.k], hops=hops, reads=0)


ALGORITHMS = {
    "velo": velo_search,
    "diskann": diskann_search,
    "starling": starling_search,
    "pipeann": pipeann_search,
    "inmemory": inmemory_search,
}
