"""The coroutine scheduler + executors (paper §3.1, Fig. 2/3).

Implements the paper's thread-per-core asynchronous execution model as a
discrete-event simulation over real algorithm executions:

  * each worker thread is a simulated timeline with its own scheduler;
  * each query is a coroutine (Python generator, see search.py protocol);
  * a cache miss suspends the coroutine; the scheduler switches to a ready
    one; the I/O driver (the SSD model, stand-in for io_uring) completes
    reads asynchronously; completed coroutines return to the ready queue;
  * if no coroutine is ready, the worker busy-polls the completion queue
    (time jumps to the next completion);
  * the batch size B caps concurrently executing queries per worker
    (paper: B = ceil(alpha * I / T)).

Synchronous execution (DiskANN-style) is the degenerate case B=1.

In-flight page reads are deduplicated (the paper's Locked slot state makes
concurrent loads of one record coalesce; we apply the same rule at page
granularity), so a prefetch racing a demand read costs one I/O, not two.
Coalesced reads are never charged an SQE submission (no SQE was issued) and
are counted in ``WorkloadStats.coalesced_reads``.

Record-level coalescing rides on top of that: a coroutine that hits a record
whose buffer-pool slot is LOCKED (another coroutine — possibly on another
worker — began its load) yields ``("load_wait", vid, pool)``.  The scheduler
parks it on the pool's waiter list; when the loader publishes the record via
``pool.finish_load`` the pool queues the waiters on ``pending_resumes`` and
the scheduler turns them into resume events (``WorkloadStats.lock_waits`` /
``coalesced_record_loads``).  No duplicate page read, no duplicate decode.

Cross-query fused dispatch (``EngineConfig.fuse``): coroutines yield their
distance work as ``("score", ScoreRequest)`` ops instead of computing it
inline.  The scheduler parks score requests from all ready coroutines on a
worker in a rendezvous buffer and flushes them as ONE fused DistanceEngine
call per request kind — when the buffered row count reaches ``fuse_rows``, or
when the worker has nothing else to run — charging a single amortized kernel
dispatch for the whole batch.  With fusion off, score ops are executed
immediately (per-query dispatch, bitwise-identical results).

Shared rendezvous (``EngineConfig.shared_rendezvous``, requires ``fuse``):
instead of one rendezvous buffer per worker, ALL workers park their score
ops in a single system-wide buffer.  It flushes when the buffered row count
reaches ``fuse_rows`` (the worker that crossed the budget initiates) or when
EVERY worker is stalled — no coroutine ready anywhere and no query left to
admit — in which case the earliest-clock contributing worker initiates.  The
initiator is charged the per-kind fused dispatches; its coroutines rejoin its
ready queue directly (first one switch-free, exactly the per-worker rule) and
the other workers' coroutines are resumed via completion events at the flush
time.  The fused batch B therefore spans the whole system, not one worker's
in-flight queries.  With one worker the flush points and charges coincide
with the per-worker topology, so results are bitwise identical; the engine
also charges a one-time ``CostModel.table_upload_s`` at the first quantized
dispatch of a run — the register-once pin of the index's resident code
tables on the distance engine (see core.distance), once per DISTINCT table
(the multi-tenant serving plane registers one table per tenant, or one
combined table for all of them).

Flush/I-O overlap (``EngineConfig.overlap_flush``, shared rendezvous only):
when every worker is stalled and a completion belonging to ANOTHER worker is
already due, the stall flush is issued immediately — the fused dispatch
overlaps with that worker's I/O drain — instead of first applying the
completion and letting its coroutine run ahead of the flush.  The
initiator's own due completions are always applied first (at one worker
every completion is its own, so the flag cannot change one-worker results —
the existing bitwise-parity contract).  ``WorkloadStats.overlap_flushes``
counts the flushes that engaged the overlap.

Multi-tenant serving (core.serving): score requests carry the registered
table they index (``ScoreRequest.qb``) and a diagnostic tenant tag; the
flush core groups by ``distance.request_group_key`` so one rendezvous flush
routes each (kind, table) group to its own fused call —
``WorkloadStats.cross_tenant_flushes`` counts flushes spanning tenants.

Sharded scatter-gather (``Engine(shards=ShardRouter(...))``, core.sharding):
the index image is split across N engine shards — each shard owns a page
range (and so the records on it), a fresh SSD, a rendezvous buffer, and a
clock.  Coroutines yield ``("scatter", ShardScatter)`` instead of
``("score", ...)``: the router splits the request's rows by owning shard and
each slice executes on ITS shard — inline on the shard clock when fusion is
off, or parked in the shard's rendezvous buffer when fusion is on (flushed
at ``fuse_rows`` per shard, or when every worker stalls — mirroring the
shared-rendezvous stall rule).  A ``ScatterJoin`` reassembles the slices in
row order and resumes the coroutine at the max part completion plus one
``CostModel.shard_merge_s`` collective when more than one shard contributed
(the dist_search all_gather + top_k merge, lifted into the engine).  Page
reads route to the owning shard's SSD.  A scatter whose rows all land on one
shard passes the ORIGINAL request through — with one shard every scatter
does, every flush charge lands at the same time on the same clock, and the
sharded engine is bitwise identical to the unsharded one (the S=1 parity
contract; tests/test_sharding.py, benchmarks/bench_sharded.py).  Resident
code tables upload once per (shard, table): each shard pins its own copy.

Fused on-device beam steps (``SearchContext.device_beam``, core.beam):
coroutines yield ``("beam", BeamRequest)`` ops — score + visited-mask +
top-k merge + frontier selection execute as ONE fused DistanceEngine call
(``beam_step_many``) whose reply is the next FRONTIER, not raw distances.
Beam ops park in the same rendezvous buffers as score ops (per-worker,
shared, or per-shard) and flush under the same rules; each fused beam group
charges ``CostModel.beam_step_s`` once per flush via the ``fused_batch_s``
kind plumbing.  On the sharded plane a multi-shard beam scatter sends each
owning shard a ``BeamShardPart`` (score locally, return the local top-L);
the join merges the slices (``ScatterJoin.merge_beam_candidates``) and the
engine folds them into the resident state exactly once via
``DistanceEngine.beam_finalize``.  ``WorkloadStats.dist_downloads`` counts
the replies that still ship raw distances — beam replies do not, which is
the whole point: downloads/query drops from ~hops x kinds to ~hops.

SLA-aware scheduling (``EngineConfig.scheduler``, core.scheduling): with
``scheduler="sla"`` and an ``SlaPlan`` handed to ``Engine.run``, queries
carry arrival times (withheld from admission until their "arrival" event
fires) and per-tenant deadlines; admission, per-worker ready picks, and
stall-flush initiator selection all order by deadline (EDF), and the plan's
feedback controller may steer the ``fuse_rows`` budget online.  The default
``scheduler="rr"`` keeps every pick FIFO and is bitwise identical to the
pre-SLA engine; a plan with arrivals additionally makes ``latencies``
measure completion-minus-arrival (queue wait included — the old
dispatch-relative number is kept in ``WorkloadStats.service_times``), while
plan=None keeps the old accounting bitwise.  See docs/scheduling.md.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from collections.abc import Callable

import numpy as np

from repro_torch.core import beam as beam_mod
from repro_torch.core import distance as distance_mod
from repro_torch.core.scheduling import SCHEDULERS
from repro_torch.core.sim import SSD, CostModel, WorkloadStats


@dataclasses.dataclass
class EngineConfig:
    n_workers: int = 1
    batch_size: int = 8        # B: coroutines in flight per worker
    page_size: int = 4096
    fuse: bool = False         # cross-query fused score dispatch
    fuse_rows: int = 256       # flush the rendezvous buffer at this row budget
    shared_rendezvous: bool = False  # one system-wide rendezvous buffer
                                     # (off = per-worker buffers;
                                     # needs fuse)
    overlap_flush: bool = False  # overlap the shared-rendezvous stall flush
                                 # with ANOTHER worker's in-flight completions
                                 # (off = drain the I/O first; at one worker
                                 # every completion is the initiator's own, so
                                 # the flag cannot change results there)
    scheduler: str = "rr"        # ready-queue policy: "rr" = FIFO round-robin
                                 # (bitwise the pre-SLA engine); "sla" = EDF —
                                 # admission, ready picks and stall-flush
                                 # initiator selection order by deadline slack
                                 # from the run's SlaPlan (core.scheduling)


class _Worker:
    __slots__ = ("wid", "t", "ready", "active", "deferred_charge", "done_queries",
                 "pending", "pending_rows", "free_gens")

    def __init__(self, wid: int):
        self.wid = wid
        self.t = 0.0
        self.ready: deque = deque()  # (gen, resume_value, qid, charge_switch)
        self.active = 0
        self.deferred_charge = 0.0
        self.done_queries = 0
        self.pending: list = []      # rendezvous buffer: (gen, qid, ScoreRequest)
        self.pending_rows = 0
        # "sla" mode only: gen ids this worker's LAST flush resumed.  The
        # switch-free credit of a flush belongs to whichever of them the EDF
        # pick runs FIRST — per-entry flags (the rr rule) would let a resume
        # that ran only after an intervening coroutine skip its switch charge.
        self.free_gens: set | None = None


class Engine:
    """Runs a workload of query coroutines over the simulated hardware."""

    def __init__(
        self,
        store,                      # PageStore: pid -> bytes (data plane)
        ssd: SSD,
        cost: CostModel,
        config: EngineConfig,
        dist=None,                  # DistanceEngine executing score ops
        qb=None,                    # QuantizedBase for estimate/refine kinds
        hbm=None,                   # core.hbm.HbmTier: HBM record-cache tier
                                    # (None == off, the bitwise-parity default)
        schedule=None,              # analysis.explore.SchedulePolicy: permutes
                                    # equal-time scheduling ties and records
                                    # the decision trace (None == identity
                                    # order, bitwise the pre-seam engine)
        verify=None,                # analysis.protocol.ProtocolChecker: runs
                                    # cheap pool invariants at flush
                                    # boundaries and end-of-run detectors
        shards=None,                # core.sharding.ShardRouter: the sharded
                                    # scatter-gather plane (None == unsharded;
                                    # fresh per run, like the SSD)
    ):
        self.store = store
        self.ssd = ssd
        self.cost = cost
        self.config = config
        self.dist = dist
        self.qb = qb
        self.hbm = hbm
        self.schedule = schedule
        self.verify = verify
        self.shards = shards

    def run(
        self,
        make_coroutine: Callable[[int, np.ndarray], object],
        queries: np.ndarray,
        sla=None,                   # core.scheduling.SlaPlan: arrival times,
                                    # deadlines and the feedback controller
                                    # (None == every query arrives at t=0 and
                                    # latency == service time, bitwise the
                                    # pre-SLA engine)
    ) -> tuple[list, WorkloadStats]:
        cfg = self.config
        assert cfg.scheduler in SCHEDULERS, f"unknown scheduler {cfg.scheduler!r}"
        if self.dist is None:
            self.dist = distance_mod.get_engine()
        # schedule-exploration / protocol-verification seams (both None in
        # production: the identity schedule and no checker are bitwise the
        # pre-seam engine — tests/test_analysis.py pins that parity)
        sched = self.schedule
        verify = self.verify
        router = self.shards
        plan = sla
        edf = cfg.scheduler == "sla"
        deadlines = plan.deadlines if plan is not None else None
        controller = plan.controller if plan is not None else None
        workers = [_Worker(i) for i in range(cfg.n_workers)]
        query_queue: deque[int] = deque(range(len(queries)))
        start_time: dict[int, float] = {}
        results: list = [None] * len(queries)
        stats = WorkloadStats(n_queries=len(queries))
        # HBM tier counters are cumulative on the tier (it outlives runs, like
        # the pool): snapshot at start, report per-run deltas at the end —
        # the same rule as for dist_uploads / pool pressure.
        hbm_c0 = self.hbm.counters() if self.hbm is not None else None

        # global completion-event heap: (time, rank, seq, kind, payload).
        # rank is 0 everywhere without a schedule policy — ordering is then
        # (time, seq), exactly the pre-seam heap; a policy assigns seeded
        # ranks so EQUAL-TIME events drain in a permuted order (actions at
        # distinct times never reorder: the explorer perturbs only ties).
        events: list = []
        seq = 0
        # in-flight page reads: pid -> completion_time (dedup window), with a
        # companion heap so completed entries are pruned instead of growing
        # one-per-page-ever-read over a long run
        inflight: dict[int, float] = {}
        inflight_heap: list[tuple[float, int]] = []
        token_counter = 0
        # token -> (pid, completion); owner tracking so a coroutine finishing
        # with outstanding tokens cannot leak its entries
        token_info: dict[int, tuple[int, float]] = {}
        tokens_by_query: dict[int, set[int]] = {}
        # exposed for tests (leak regression checks inspect them after run)
        self._inflight = inflight
        self._token_info = token_info
        self._tokens_by_query = tokens_by_query

        def issue_read(
            t: float, pid: int, worker: _Worker, charge_submit: bool = False
        ) -> tuple[float, float]:
            """Submit one page read with in-flight dedup.  Returns (completion
            time, new worker time): coalescing with an already in-flight page
            submits no SQE, so no ``io_submit_s`` is charged for it; genuinely
            issued reads pay SQE prep BEFORE the device sees the command (only
            when ``charge_submit`` — the submit/submit_cb ops charge their
            batch up front instead)."""
            # Prune dedup entries whose completion no future read can observe.
            # A worker only matters for the horizon if it can still issue
            # reads: it has active coroutines, or queries remain to admit —
            # including queries that have not ARRIVED yet (an idle drained
            # worker would otherwise pin the horizon at its final time and
            # the dict would grow one entry per page forever).
            if query_queue or n_unarrived:
                horizon = min(w.t for w in workers)
            else:
                horizon = min((w.t for w in workers if w.active > 0),
                              default=float("inf"))
            while inflight_heap and inflight_heap[0][0] <= horizon:
                c, p = heapq.heappop(inflight_heap)
                if inflight.get(p) == c:
                    del inflight[p]
            comp = inflight.get(pid)
            if comp is not None and comp > t:
                stats.coalesced_reads += 1
                return comp, t
            if charge_submit:
                t += self.cost.io_submit_s
            # sharded plane: the read executes on the device of the shard
            # that owns the page (disjoint page ranges, so the global
            # in-flight dedup above stays correct across shards)
            dev = self.ssd if router is None else router.ssd_for_page(pid)
            comp = dev.submit(t, cfg.page_size)
            inflight[pid] = comp
            heapq.heappush(inflight_heap, (comp, pid))
            stats.io_count += 1
            stats.io_bytes += cfg.page_size
            return comp, t

        def drop_query_tokens(qid: int) -> None:
            """Forget any tokens a finished coroutine never waited on."""
            for tok in tokens_by_query.pop(qid, ()):
                token_info.pop(tok, None)

        def push_event(time: float, kind: str, payload) -> None:
            nonlocal seq
            rank = 0 if sched is None else sched.event_rank(seq)
            heapq.heappush(events, (time, rank, seq, kind, payload))
            seq += 1

        # Open-loop arrivals (SlaPlan): a query with arrival > 0 is withheld
        # from the admission queue until its "arrival" event fires — the
        # busy-poll branch of the global loop then jumps time to it exactly
        # like an I/O completion.  All-zero arrivals (and plan=None) seed the
        # full queue up front, the pre-SLA admission order.
        n_unarrived = 0
        if plan is not None:
            arr = plan.arrivals
            assert arr.shape == (len(queries),), (
                f"SlaPlan has {arr.shape[0]} arrivals for {len(queries)} queries"
            )
            if np.any(arr > 0.0):
                query_queue = deque(
                    int(q) for q in np.flatnonzero(arr <= 0.0)
                )
                for q in np.flatnonzero(arr > 0.0):
                    push_event(float(arr[q]), "arrival", int(q))
                    n_unarrived += 1

        def fuse_budget() -> int:
            """The rendezvous flush row budget — static ``cfg.fuse_rows``
            unless the SLA feedback controller is steering it online."""
            if controller is None:
                return cfg.fuse_rows
            return controller.fuse_rows(cfg.fuse_rows)

        def qdeadline(qid: int) -> float:
            return float(deadlines[qid]) if deadlines is not None else float("inf")

        def pick_query(w: _Worker) -> int:
            """Pop the next query to admit: FIFO in rr; earliest deadline in
            sla (EDF starts at admission — a slack-critical query must not
            sit behind the hot tenant's backlog in the arrival queue)."""
            if not edf or deadlines is None or len(query_queue) == 1:
                return query_queue.popleft()
            best = None
            best_key = None
            for q in query_queue:
                key = (qdeadline(q), q)
                if best_key is None or key < best_key:
                    best, best_key = q, key
            if sched is not None:
                tied = [q for q in query_queue if qdeadline(q) == best_key[0]]
                if len(tied) > 1:
                    sched.ties["slack"] += 1
                    best = min(tied, key=lambda q: (sched.slack_rank(q), q))
            query_queue.remove(best)
            return best

        def pop_ready(w: _Worker) -> tuple:
            """Pop the next ready entry: FIFO in rr (bitwise the pre-SLA
            engine, per-entry switch flags untouched); in sla, the entry with
            the earliest deadline (queue position breaks exact ties — or the
            explorer's slack_rank when a schedule policy is attached, since
            equal-slack picks are a genuine scheduling race).  The sla pop
            also resolves the flush switch-free credit: the FIRST pop after a
            flush is free iff it resumes one of that flush's own coroutines
            (see _Worker.free_gens)."""
            if not edf:
                return w.ready.popleft()
            if deadlines is None or len(w.ready) == 1:
                entry = w.ready.popleft()
            else:
                best_i = 0
                best_key = (qdeadline(w.ready[0][2]), 0)
                for i in range(1, len(w.ready)):
                    key = (qdeadline(w.ready[i][2]), i)
                    if key < best_key:
                        best_i, best_key = i, key
                if sched is not None:
                    tied = [
                        i for i in range(len(w.ready))
                        if qdeadline(w.ready[i][2]) == best_key[0]
                    ]
                    if len(tied) > 1:
                        sched.ties["slack"] += 1
                        best_i = min(
                            tied,
                            key=lambda i: (sched.slack_rank(w.ready[i][2]), i),
                        )
                entry = w.ready[best_i]
                del w.ready[best_i]
            gen, value, qid, charge_switch = entry
            if w.free_gens is not None:
                # one credit per flush, consumed by the first pop whatever it
                # is: free only when it IS one of the flush's own resumes
                charge_switch = id(gen) not in w.free_gens
                w.free_gens = None
            return gen, value, qid, charge_switch

        def parked_deadline(w: _Worker) -> float:
            """Earliest deadline among the work a stalled worker has parked
            in the shared/sharded rendezvous — the sla stall-flush initiator
            key (inf in rr / without deadlines: selection degenerates to the
            earliest-clock rule)."""
            if not edf or deadlines is None:
                return float("inf")
            best = float("inf")
            for wk, _, qid, _ in shared_pending:
                if wk is w:
                    best = min(best, qdeadline(qid))
            if router is not None:
                for plist in router.pending:
                    for join, _, _ in plist:
                        if join.worker is w:
                            best = min(best, qdeadline(join.qid))
            return best

        # buffer pools with coroutines parked on LOCKED slots (load_wait op),
        # keyed by id so registration order — not hash order — drives the
        # resume drain; their pending_resumes queues are drained after every
        # action that can publish a record (worker step or prefetch callback)
        wait_pools: dict[int, object] = {}

        def drain_pool_resumes(now: float) -> None:
            """Turn records published by finish_load into resume events for
            the coroutines parked on the LOCKED slot — record-level
            coalescing across all workers.  The pending check keeps the
            common (nothing-published) case allocation-free on the hot
            scheduling path."""
            for pool in wait_pools.values():
                if not pool.pending_resumes:
                    continue
                for (wkr, gen, qid), rec in pool.take_resumes():
                    if rec is not None:
                        stats.coalesced_record_loads += 1
                    push_event(now, "resume", (wkr, gen, rec, qid))

        def apply_due_events(now: float) -> None:
            """Apply completions (callbacks / worker resumes / query
            arrivals) due by `now`."""
            nonlocal n_unarrived
            while events and events[0][0] <= now:
                time, _, _, kind, payload = heapq.heappop(events)
                if sched is not None and events and events[0][0] == time:
                    sched.ties["event"] += 1  # a genuinely permutable tie
                if kind == "callback":
                    cb, pid, issuer = payload
                    cb(pid, self.store.read_page(pid))
                    issuer.deferred_charge += self.cost.record_decode_s
                    # a prefetch callback may finish_load a LOCKED slot:
                    # resume its waiters at the completion time
                    drain_pool_resumes(time)
                elif kind == "resume":
                    worker, gen, value, qid = payload
                    worker.t = max(worker.t, time)
                    worker.ready.append((gen, value, qid, True))
                elif kind == "arrival":
                    # the query is now admissible; a worker clamps its clock
                    # to the arrival time when it actually picks it up
                    query_queue.append(payload)
                    n_unarrived -= 1

        # one-time resident-table pin: the first dispatch of a run that
        # touches a quantized index charges the register-once upload of its
        # code tables to the distance engine (core.distance.register_index).
        # One charge per DISTINCT table — a single-tenant run charges exactly
        # once; the serving plane charges once per registered
        # tenant table (once total when the tenants share a combined table).
        uploaded_tables: set = set()

        def upload_charge_s(reqs, shard: int | None = None) -> float:
            """Seconds of one-time table pins owed by this batch.  On the
            sharded plane each shard keeps its own distance executor, so the
            pin is once per (shard, table) — with one shard that degenerates
            to once per table, the unsharded rule."""
            charge = 0.0
            for r in reqs:
                if r.kind not in ("estimate", "refine"):
                    continue
                qb = r.qb if r.qb is not None else self.qb
                if qb is None:
                    continue
                key = id(qb) if shard is None else (shard, id(qb))
                if key not in uploaded_tables:
                    uploaded_tables.add(key)
                    charge += self.cost.table_upload_s
            return charge

        def charge_upload(w: _Worker, reqs) -> None:
            w.t += upload_charge_s(reqs)

        def hbm_split(reqs) -> tuple[dict, dict]:
            """Resolve each id-payload refine request against the HBM tier:
            ``splits`` maps ``id(req)`` to its (hit_mask, slots) partition;
            ``rebates`` accumulates, per dispatch group, the simulated seconds
            the slot-gather saves over the registered-table refine (hit rows
            are charged ``hbm_refine_ext`` instead of ``refine_ext``)."""
            splits: dict[int, tuple] = {}
            rebates: dict[tuple, float] = {}
            for r in reqs:
                if r.kind != "refine" or isinstance(r.payload, tuple):
                    continue
                rqb = r.qb if r.qb is not None else self.qb
                if rqb is None or not self.hbm.covers(rqb):
                    continue
                sp = self.hbm.peek_split(np.asarray(r.payload, dtype=np.int64))
                if sp is None:
                    continue
                mask, slots = sp
                splits[id(r)] = (mask, slots)
                key = distance_mod.request_group_key(r, self.qb)
                per_row = max(
                    0.0,
                    self.cost.refine_ext(rqb.dim)
                    - self.cost.hbm_refine_ext(rqb.dim),
                )
                rebates[key] = rebates.get(key, 0.0) + per_row * int(mask.sum())
            return splits, rebates

        def dispatch_batch(initiator: _Worker, reqs: list) -> list:
            """The flush core both rendezvous topologies share: one fused
            dispatch per request group present (``distance.request_group_key``
            — per kind, and per registered table across tenants), each charged
            a single amortized dispatch to the initiating worker (plus the
            one-time table uploads), stats updated.  Returns the per-request
            results.  Keeping this in ONE place is what guarantees the
            1-worker bitwise parity between the topologies.

            With the HBM tier on, refine requests are split against the cache
            slots first (hit rows gather on-device at ``hbm_refine_ext`` cost,
            charged as a rebate on the group's flops), and the scatter DMA
            installing the records staged since the LAST boundary overlaps
            this flush's fused dispatch: only ``hbm_scatter_s`` net of the
            dispatch time is charged (double buffering — compute step t hides
            the installs for step t+1)."""
            charge_upload(initiator, reqs)
            splits = rebates = None
            if self.hbm is not None:
                splits, rebates = hbm_split(reqs)
            flop_by_group: dict[tuple, float] = {}
            tenants_by_group: dict[tuple, set] = {}
            for r in reqs:
                key = distance_mod.request_group_key(r, self.qb)
                flop_by_group[key] = flop_by_group.get(key, 0.0) + r.flop_s
                tenants_by_group.setdefault(key, set()).add(r.tenant)
            dispatch_s = 0.0
            for key, flop_s in flop_by_group.items():
                if rebates:
                    flop_s = max(0.0, flop_s - rebates.get(key, 0.0))
                d = self.cost.fused_batch_s(flop_s, kind=key[0])
                initiator.t += d
                dispatch_s += d
            outs = distance_mod.execute_requests(
                self.dist, self.qb, reqs, hbm=self.hbm, splits=splits
            )
            stats.score_flushes += len(flop_by_group)
            stats.score_requests += len(reqs)
            stats.score_rows += sum(r.rows for r in reqs)
            n_beam = sum(
                1 for r in reqs if isinstance(r, beam_mod.BeamRequest)
            )
            stats.beam_ops += n_beam
            stats.beam_rows += sum(
                r.rows for r in reqs if isinstance(r, beam_mod.BeamRequest)
            )
            stats.beam_flushes += sum(
                1 for key in flop_by_group if key[0].startswith("beam")
            )
            # beam replies ship a frontier, not distances — everything else
            # in the flush still downloads its raw per-row result
            stats.dist_downloads += len(reqs) - n_beam
            # cross-tenant FUSION means one dispatch group genuinely spanned
            # tenants — a flush whose per-tenant requests were routed to
            # separate per-table calls does not count
            if any(len(ts) > 1 for ts in tenants_by_group.values()):
                stats.cross_tenant_flushes += 1
            if self.hbm is not None:
                n_scattered = self.hbm.scatter_staged()
                if n_scattered:
                    initiator.t += max(
                        0.0, self.cost.hbm_scatter_s - dispatch_s
                    )
                    if sched is not None:
                        sched.note(("scatter", n_scattered))
            if verify is not None:
                verify.at_flush()
            return outs

        def flush_scores(w: _Worker) -> None:
            """Flush the per-worker rendezvous buffer: every parked coroutine
            returns to the ready queue with its result."""
            pend, w.pending, w.pending_rows = w.pending, [], 0
            outs = dispatch_batch(w, [r for _, _, r in pend])
            for i, ((gen, qid, _), val) in enumerate(zip(pend, outs)):
                # the first resume continues straight out of the fused
                # dispatch — no switch charge, so a rendezvous of one costs
                # exactly what inline execution costs; every later resume is
                # a genuine coroutine switch and pays for it.  In sla mode
                # the EDF pick decides which resume runs first, so the credit
                # moves to pop time (free_gens) instead of entry flags.
                w.ready.append((gen, val, qid, True if edf else i > 0))
            if edf:
                w.free_gens = {id(gen) for gen, _, _ in pend}

        # system-wide shared rendezvous: (worker, gen, qid, req) from ALL
        # workers, flushed at fuse_rows or when every worker is stalled
        shared = cfg.fuse and cfg.shared_rendezvous
        shared_pending: list = []
        shared_rows = 0

        def flush_shared(initiator: _Worker) -> None:
            """Flush the system-wide rendezvous buffer.  The initiator (the
            worker that crossed the row budget, or the earliest-clock
            contributor when every worker stalled) drives the fused dispatch
            and is charged for it; its own coroutines rejoin its ready queue
            directly — the first without a switch charge, exactly the
            per-worker flush rule, so a one-worker system is bitwise
            identical to per-worker fusion — while other workers' coroutines
            are resumed via events at the flush completion time."""
            nonlocal shared_pending, shared_rows
            pend, shared_pending, shared_rows = shared_pending, [], 0
            outs = dispatch_batch(initiator, [r for _, _, _, r in pend])
            first_own = True
            own_gens = set()
            for (wkr, gen, qid, _), val in zip(pend, outs):
                if wkr is initiator:
                    wkr.ready.append(
                        (gen, val, qid, True if edf else not first_own)
                    )
                    first_own = False
                    own_gens.add(id(gen))
                else:
                    push_event(initiator.t, "resume", (wkr, gen, val, qid))
            if edf and own_gens:
                initiator.free_gens = own_gens

        def finish_beam_join(join) -> object:
            """Resolve a completed beam join into its BeamResult: the
            single-owner passthrough already executed the ORIGINAL request
            (the S=1 parity lever — bitwise the unsharded beam step);
            multi-shard joins merge the per-shard local top-Ls and fold them
            into the resident state exactly once (pending inserts/marks
            applied at the finalize, never per part)."""
            if join.direct is not None:
                return join.direct
            req = join.beam_req
            ids, ds = join.merge_beam_candidates()
            rqb = req.qb if req.qb is not None else self.qb
            return self.dist.beam_finalize(rqb, req, ids, ds)

        def flush_sharded(initiator: _Worker, only=None) -> None:
            """Flush the per-shard rendezvous buffers — all of them at a
            stall, or the budget-crossing subset ``only``.  Each shard's
            parked slices dispatch on ITS OWN clock, starting no earlier than
            the initiator's time, so shards execute in parallel with each
            other.  A join whose every part completed resumes its coroutine
            at the max part completion plus one merge collective (multi-shard
            joins only); the initiator's own completed joins rejoin its ready
            queue directly — the first switch-free, exactly the
            ``flush_shared`` rule, which with ONE shard makes the charge
            sequence and resume order bitwise identical to the unsharded
            shared-rendezvous flush (the S=1 parity contract)."""
            t0 = initiator.t
            done: list = []
            shard_ids = range(router.n_shards) if only is None else only
            for s in shard_ids:
                pend = router.pending[s]
                if not pend:
                    continue
                router.pending[s] = []
                router.pending_rows[s] = 0
                reqs = [r for _, r, _ in pend]
                st = max(router.shard_t[s], t0)
                st += upload_charge_s(reqs, shard=s)
                flop_by_group: dict[tuple, float] = {}
                tenants_by_group: dict[tuple, set] = {}
                for r in reqs:
                    key = distance_mod.request_group_key(r, self.qb)
                    flop_by_group[key] = flop_by_group.get(key, 0.0) + r.flop_s
                    tenants_by_group.setdefault(key, set()).add(r.tenant)
                for key, flop_s in flop_by_group.items():
                    st += self.cost.fused_batch_s(flop_s, kind=key[0])
                outs = distance_mod.execute_requests(self.dist, self.qb, reqs)
                router.shard_t[s] = st
                stats.score_flushes += len(flop_by_group)
                stats.score_requests += len(reqs)
                stats.score_rows += sum(r.rows for r in reqs)
                stats.beam_flushes += sum(
                    1 for key in flop_by_group if key[0].startswith("beam")
                )
                stats.shard_flushes += 1
                if any(len(ts) > 1 for ts in tenants_by_group.values()):
                    stats.cross_tenant_flushes += 1
                for (join, _, ridx), val in zip(pend, outs):
                    if join.put(ridx, val, st):
                        done.append(join)
                if verify is not None:
                    verify.at_flush()
            first_own = True
            own_gens = set()
            for join in done:
                t_done = join.t_done
                if join.n_parts > 1:
                    t_done += self.cost.shard_merge_s
                    stats.shard_merges += 1
                if join.beam_req is not None:
                    merged = finish_beam_join(join)
                    stats.beam_ops += 1
                    stats.beam_rows += join.beam_req.rows
                else:
                    merged = join.merge()
                    stats.dist_downloads += 1
                if join.worker is initiator:
                    initiator.t = max(initiator.t, t_done)
                    initiator.ready.append(
                        (join.gen, merged, join.qid,
                         True if edf else not first_own)
                    )
                    first_own = False
                    own_gens.add(id(join.gen))
                else:
                    push_event(
                        t_done, "resume",
                        (join.worker, join.gen, merged, join.qid),
                    )
            if edf and own_gens:
                initiator.free_gens = own_gens

        def run_worker_action(w: _Worker) -> None:
            """One scheduling action on worker w (paper Fig. 3b loop body)."""
            w.t += w.deferred_charge
            w.deferred_charge = 0.0

            if not w.ready:
                if query_queue and w.active < cfg.batch_size:
                    qid = pick_query(w)
                    gen = make_coroutine(qid, queries[qid])
                    w.active += 1
                    if plan is not None:
                        # an idle worker picking up a not-yet-arrived... —
                        # cannot happen (arrival events gate the queue) —
                        # but a worker whose clock is BEHIND the arrival
                        # idles until it: dispatch never precedes arrival
                        w.t = max(w.t, float(plan.arrivals[qid]))
                    start_time[qid] = w.t
                    w.ready.append((gen, None, qid, True))
                elif w.pending:
                    # nothing else can run: flush the rendezvous buffer so the
                    # parked scorers make progress.  (Shared topology: a lone
                    # stalled worker must NOT flush — the global loop flushes
                    # only when EVERY worker is stalled.)
                    flush_scores(w)
                else:
                    return

            gen, value, qid, charge_switch = pop_ready(w)
            if charge_switch:
                w.t += self.cost.coroutine_switch_s
                stats.coroutine_switches += 1

            while True:
                try:
                    op = gen.send(value)
                except StopIteration as fin:
                    drain_pool_resumes(w.t)  # publishes from this final step
                    results[qid] = fin.value
                    service = w.t - start_time[qid]
                    if plan is None:
                        # no arrival schedule: latency == service time, the
                        # pre-SLA numbers, bitwise
                        latency = service
                    else:
                        # latency runs from ARRIVAL: queue wait (the tail's
                        # dominant term under burst) now reaches p99
                        latency = w.t - float(plan.arrivals[qid])
                    stats.sum_latency_s += latency
                    stats.latencies.append(latency)
                    stats.latency_qids.append(qid)
                    stats.sum_service_s += service
                    stats.service_times.append(service)
                    stats.queue_wait_s += latency - service
                    if deadlines is not None:
                        dl = float(deadlines[qid])
                        if w.t <= dl:
                            stats.deadline_hits += 1
                        else:
                            stats.deadline_misses += 1
                            stats.lateness_s += w.t - dl
                    if plan is not None:
                        plan.on_complete(qid, w.t, latency)
                    drop_query_tokens(qid)
                    w.active -= 1
                    w.done_queries += 1
                    return

                # a finish_load in the step that produced this op resumes its
                # waiters AT the publish time, before later ops advance w.t
                if wait_pools:
                    drain_pool_resumes(w.t)

                kind = op[0]
                if kind == "compute":
                    w.t += op[1]
                    value = None
                elif kind == "score":
                    req = op[1]
                    if shared:
                        nonlocal shared_rows
                        shared_pending.append((w, gen, qid, req))
                        shared_rows += req.rows
                        if shared_rows >= fuse_budget():
                            flush_shared(w)
                        return  # parked in the system-wide rendezvous
                    if cfg.fuse:
                        w.pending.append((gen, qid, req))
                        w.pending_rows += req.rows
                        if w.pending_rows >= fuse_budget():
                            flush_scores(w)
                        return  # parked in the rendezvous buffer
                    # fusion off: execute immediately (per-query dispatch)
                    charge_upload(w, (req,))
                    if self.hbm is not None:
                        splits, rebates = hbm_split([req])
                        key = distance_mod.request_group_key(req, self.qb)
                        flop_s = max(
                            0.0, req.flop_s - rebates.get(key, 0.0)
                        ) if rebates else req.flop_s
                        d = self.cost.fused_batch_s(flop_s, kind=key[0])
                        w.t += d
                        value = distance_mod.execute_requests(
                            self.dist, self.qb, [req],
                            hbm=self.hbm, splits=splits,
                        )[0]
                        n_scattered = self.hbm.scatter_staged()
                        if n_scattered:
                            w.t += max(0.0, self.cost.hbm_scatter_s - d)
                            if sched is not None:
                                sched.note(("scatter", n_scattered))
                    else:
                        w.t += self.cost.fused_batch_s(req.flop_s)
                        value = distance_mod.execute_requests(
                            self.dist, self.qb, [req]
                        )[0]
                    stats.dist_downloads += 1
                    if verify is not None:
                        # the per-query dispatch is the degenerate flush
                        # boundary (fusion off): same invariant cadence
                        verify.at_flush()
                elif kind == "beam":
                    req = op[1]
                    if shared:
                        shared_pending.append((w, gen, qid, req))
                        shared_rows += req.rows
                        if shared_rows >= fuse_budget():
                            flush_shared(w)
                        return  # parked in the system-wide rendezvous
                    if cfg.fuse:
                        w.pending.append((gen, qid, req))
                        w.pending_rows += req.rows
                        if w.pending_rows >= fuse_budget():
                            flush_scores(w)
                        return  # parked in the rendezvous buffer
                    # fusion off: one fused beam launch for this query alone
                    # (still a single exchange — the reply is the frontier)
                    charge_upload(w, (req,))
                    key = distance_mod.request_group_key(req, self.qb)
                    w.t += self.cost.fused_batch_s(req.flop_s, kind=key[0])
                    value = distance_mod.execute_requests(
                        self.dist, self.qb, [req]
                    )[0]
                    stats.beam_ops += 1
                    stats.beam_flushes += 1
                    stats.beam_rows += req.rows
                    if verify is not None:
                        verify.at_flush()
                elif kind == "scatter":
                    sc = op[1]
                    parts = router.split(sc)
                    stats.scatter_ops += 1
                    is_beam = isinstance(sc.req, beam_mod.BeamRequest)
                    if cfg.fuse:
                        # park each slice in its owning shard's rendezvous
                        # buffer; flush every shard this scatter pushed over
                        # the row budget (with one shard: exactly the shared
                        # rendezvous budget rule)
                        join = router.make_join(
                            w, gen, qid, sc.req.rows, len(parts),
                            beam_req=sc.req if is_beam else None,
                        )
                        crossed = []
                        for s, sub, ridx in parts:
                            router.pending[s].append((join, sub, ridx))
                            router.pending_rows[s] += sub.rows
                            if router.pending_rows[s] >= fuse_budget():
                                crossed.append(s)
                        if crossed:
                            flush_sharded(w, only=crossed)
                        return  # parked in the per-shard rendezvous buffers
                    # fusion off: each slice dispatches inline on its owning
                    # shard's clock; the worker resumes at the last slice's
                    # completion plus the merge collective (multi-shard only)
                    join = (
                        router.make_join(
                            w, gen, qid, sc.req.rows, len(parts),
                            beam_req=sc.req,
                        ) if is_beam else None
                    )
                    t0 = w.t
                    comp = t0
                    merged = None
                    out_rows = None
                    for s, sub, ridx in parts:
                        st = max(router.shard_t[s], t0)
                        st += upload_charge_s((sub,), shard=s)
                        if is_beam:
                            gkey = distance_mod.request_group_key(sub, self.qb)
                            st += self.cost.fused_batch_s(
                                sub.flop_s, kind=gkey[0]
                            )
                        else:
                            st += self.cost.fused_batch_s(sub.flop_s)
                        val = distance_mod.execute_requests(
                            self.dist, self.qb, [sub]
                        )[0]
                        router.shard_t[s] = st
                        comp = max(comp, st)
                        if join is not None:
                            join.put(ridx, val, st)
                        elif ridx is None:
                            merged = val
                        else:
                            if out_rows is None:
                                out_rows = np.empty(
                                    sc.req.rows, dtype=np.asarray(val).dtype
                                )
                            out_rows[ridx] = val
                    if len(parts) > 1:
                        comp += self.cost.shard_merge_s
                        stats.shard_merges += 1
                    w.t = comp
                    if join is not None:
                        value = finish_beam_join(join)
                        stats.beam_ops += 1
                        stats.beam_flushes += len(parts)
                        stats.beam_rows += sc.req.rows
                    else:
                        value = merged if merged is not None else out_rows
                        stats.dist_downloads += 1
                    if verify is not None:
                        # per-query sharded dispatch: the degenerate flush
                        # boundary, same cadence as the fuse-off score path
                        verify.at_flush()
                elif kind == "load_wait":
                    _, vid, pool = op
                    if pool.is_loading(vid):
                        # park on the LOCKED slot; finish_load resumes us with
                        # the record (one I/O for the whole waiter cohort)
                        wait_pools[id(pool)] = pool
                        pool.add_waiter(vid, (w, gen, qid))
                        stats.lock_waits += 1
                        return  # suspended on the in-flight load
                    # window already closed (published or aborted) before the
                    # scheduler saw the op: resolve inline, stat-free — the
                    # searcher already counted this access as a miss
                    value = pool.peek_record(vid)
                elif kind == "read":
                    pids = op[1]
                    comp = 0.0
                    for pid in pids:
                        c, w.t = issue_read(w.t, pid, w, charge_submit=True)
                        comp = max(comp, c)
                    pages = {pid: self.store.read_page(pid) for pid in pids}
                    push_event(comp, "resume", (w, gen, pages, qid))
                    return  # suspended
                elif kind == "submit_cb":
                    _, pids, cb = op
                    w.t += self.cost.io_submit_s
                    for pid in pids:
                        comp, _ = issue_read(w.t, pid, w)
                        push_event(comp, "callback", (cb, pid, w))
                    value = None
                elif kind == "submit":
                    nonlocal token_counter
                    pids = op[1]
                    w.t += self.cost.io_submit_s
                    tokens = []
                    for pid in pids:
                        comp, _ = issue_read(w.t, pid, w)
                        token_counter += 1
                        token_info[token_counter] = (pid, comp)
                        tokens_by_query.setdefault(qid, set()).add(token_counter)
                        tokens.append(token_counter)
                    value = tokens
                elif kind == "wait_any":
                    tokens = op[1]
                    # ties on completion time break by token id (submission
                    # order), NOT set iteration order — the relative order of
                    # one query's tokens is the same whether its engine is
                    # isolated or shared with other tenants (serving-plane
                    # isolation contract)
                    tok = min(tokens, key=lambda tk: (token_info[tk][1], tk))
                    pid, comp = token_info.pop(tok)
                    if sched is not None:
                        # the tie-break decision, exposed for replay checks
                        sched.note(("wait_any", qid, pid))
                    toks = tokens_by_query.get(qid)
                    if toks is not None:
                        toks.discard(tok)
                    push_event(
                        comp, "resume", (w, gen, (tok, pid, self.store.read_page(pid)), qid)
                    )
                    return  # suspended
                else:  # pragma: no cover
                    raise ValueError(f"unknown op {kind}")

        # ------------------------------------------------------- global loop
        def pick_initiator(contributors) -> _Worker:
            """The worker that drives a stall flush.  rr: the earliest-clock
            contributor (it would otherwise sit idle) — the pre-SLA rule,
            bitwise.  sla: the contributor whose PARKED work has the earliest
            deadline (ties by clock, then wid) — the flush resumes that
            worker's most-slack-critical coroutine first (switch-free), so
            initiator choice is itself an EDF decision."""
            if edf and deadlines is not None:
                if sched is None:
                    initiator = min(
                        contributors,
                        key=lambda x: (parked_deadline(x), x.t, x.wid),
                    )
                else:
                    initiator = min(
                        contributors,
                        key=lambda x: (
                            parked_deadline(x), x.t, sched.worker_rank(x.wid)
                        ),
                    )
                    d0 = parked_deadline(initiator)
                    if sum(1 for x in contributors
                           if parked_deadline(x) == d0
                           and x.t == initiator.t) > 1:
                        sched.ties["slack"] += 1
                return initiator
            if sched is None:
                return min(contributors, key=lambda x: (x.t, x.wid))
            initiator = min(
                contributors, key=lambda x: (x.t, sched.worker_rank(x.wid))
            )
            if sum(1 for x in contributors if x.t == initiator.t) > 1:
                sched.ties["worker"] += 1
            return initiator

        def runnable(w: _Worker) -> bool:
            # a worker whose only work sits in the SHARED rendezvous is
            # stalled — it cannot flush alone; w.pending is per-worker only
            return (
                bool(w.ready)
                or bool(w.pending)
                or (bool(query_queue) and w.active < cfg.batch_size)
            )

        while True:
            cand = [w for w in workers if runnable(w)]
            next_event_t = events[0][0] if events else None
            if cand:
                if sched is None:
                    w = min(cand, key=lambda x: x.t)
                else:
                    # equal-clock candidates are a genuine scheduling race:
                    # permute which one runs (identity when rank == wid)
                    w = min(cand, key=lambda x: (x.t, sched.worker_rank(x.wid)))
                    if sum(1 for x in cand if x.t == w.t) > 1:
                        sched.ties["worker"] += 1
                if next_event_t is not None and next_event_t <= w.t:
                    apply_due_events(w.t)
                run_worker_action(w)
                # the action may have published LOCKED slots (finish_load on a
                # demand path): reschedule the parked waiters now
                drain_pool_resumes(w.t)
            elif shared_pending:
                # every worker is stalled: flush the system-wide rendezvous.
                # The earliest-clock contributing worker initiates (it would
                # otherwise sit idle) — the fused batch spans all workers.
                contributors = {id(wk): wk for wk, _, _, _ in shared_pending}
                initiator = pick_initiator(contributors.values())
                if next_event_t is not None and next_event_t <= initiator.t:
                    def initiator_due() -> bool:
                        # ANY due completion of the initiator's own forces the
                        # apply-first path — the overlap never reorders the
                        # initiator's own completions past its flush
                        for time, _, _, kind, payload in events:
                            if time > initiator.t:
                                continue
                            wkr = payload[2] if kind == "callback" else payload[0]
                            if wkr is initiator:
                                return True
                        return False

                    if not cfg.overlap_flush or initiator_due():
                        # completions already due would have been applied
                        # before a per-worker flush action; apply them and
                        # re-evaluate — a resumed coroutine runs before the
                        # rendezvous flushes.  The overlap path never reorders
                        # the initiator's OWN completions past its flush — at
                        # one worker every completion is the initiator's, so
                        # overlap on/off is bitwise identical there (the
                        # existing 1-worker parity contract).
                        apply_due_events(initiator.t)
                        continue
                    # overlap the flush with the I/O drain: ANOTHER worker's
                    # completion is in flight — issue the fused dispatch now
                    # instead of after applying it; the completion drains
                    # while the dispatch executes and is applied by the next
                    # scheduling round at its own completion time.
                    stats.overlap_flushes += 1
                    flush_shared(initiator)
                    drain_pool_resumes(initiator.t)
                    continue
                # flush, then continue the initiator in the same breath: its
                # first coroutine resumes straight out of the fused dispatch
                # with no event application in between, exactly the
                # per-worker flush action (1 worker => bitwise identical)
                flush_shared(initiator)
                run_worker_action(initiator)
                drain_pool_resumes(initiator.t)
            elif router is not None and router.has_pending():
                # every worker is stalled: flush EVERY shard's rendezvous
                # buffer (the sharded twin of the shared-rendezvous stall
                # rule).  The earliest-clock worker owning a parked join
                # initiates; each shard dispatches on its own clock from the
                # initiator's time, so the flush work itself scales out.
                contributors: dict[int, _Worker] = {}
                for plist in router.pending:
                    for join, _, _ in plist:
                        contributors.setdefault(id(join.worker), join.worker)
                initiator = pick_initiator(contributors.values())
                if next_event_t is not None and next_event_t <= initiator.t:
                    # completions already due run before the stall flush —
                    # the same apply-first rule as the shared branch (the
                    # overlap refinement is a shared-rendezvous feature; the
                    # sharded plane always drains first)
                    apply_due_events(initiator.t)
                    continue
                flush_sharded(initiator)
                run_worker_action(initiator)
                drain_pool_resumes(initiator.t)
            elif events:
                t0 = events[0][0]
                apply_due_events(t0)  # busy-poll: jump to next completion
            else:
                break

        stats.makespan_s = max((w.t for w in workers), default=0.0)
        if router is not None:
            # every shard's final flush feeds a join some worker resumed at
            # or after it, so this max is the worker max already — kept
            # explicit so the invariant cannot silently rot
            stats.makespan_s = max([stats.makespan_s, *router.shard_t])
        if verify is not None:
            verify.at_end()
        if hbm_c0 is not None:
            c1 = self.hbm.counters()
            stats.hbm_hits = c1["hits"] - hbm_c0["hits"]
            stats.hbm_misses = c1["misses"] - hbm_c0["misses"]
            stats.hbm_scatters = c1["scatters"] - hbm_c0["scatters"]
            stats.hbm_evictions = c1["evictions"] - hbm_c0["evictions"]
        return results, stats


def run_workload(
    make_coroutine: Callable[[int, np.ndarray], object],
    queries: np.ndarray,
    store,
    cost: CostModel | None = None,
    ssd: SSD | None = None,
    n_workers: int = 1,
    batch_size: int = 8,
    page_size: int = 4096,
    dist=None,
    qb=None,
    fuse: bool = False,
    fuse_rows: int = 256,
    shared_rendezvous: bool = False,
    overlap_flush: bool = False,
    scheduler: str = "rr",
    hbm=None,
    schedule=None,
    verify=None,
    shards=None,
    sla=None,
) -> tuple[list, WorkloadStats]:
    """Convenience wrapper: build an engine, run all queries, return results+stats."""
    engine = Engine(
        store=store,
        ssd=ssd or SSD(),
        cost=cost or CostModel(),
        config=EngineConfig(
            n_workers=n_workers, batch_size=batch_size, page_size=page_size,
            fuse=fuse, fuse_rows=fuse_rows, shared_rendezvous=shared_rendezvous,
            overlap_flush=overlap_flush, scheduler=scheduler,
        ),
        dist=dist,
        qb=qb,
        hbm=hbm,
        schedule=schedule,
        verify=verify,
        shards=shards,
    )
    return engine.run(make_coroutine, queries, sla=sla)
