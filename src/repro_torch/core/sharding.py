"""Sharded scatter-gather serving plane (paper §3.4 at serving scale).

Affinity-based placement co-locates related records so one fetch serves many
hops; at production scale the same principle says the distance work should
execute on the shard that OWNS the data (the near-data argument).  This
module shards one index image across N engine shards and routes each query's
frontier to the owning shards:

  * ``ShardPlan``   — the page->shard / vid->shard assignment (pages are the
    atomic unit: the affinity layout never splits a group across pages, so
    page-granular sharding preserves co-placement — see
    ``placement.shard_pages``);
  * ``ShardScatter`` — the operand of the engine's ``("scatter", ...)`` op: a
    ScoreRequest plus the owning shard of each of its rows.  Coroutines build
    it via ``SearchContext.shard_plan`` (search.py) and never see shards
    otherwise — the algorithm stays orthogonal to the execution model;
  * ``ShardRouter`` — the engine-side runtime: one fresh SSD and one
    rendezvous buffer and one clock PER SHARD.  ``split`` partitions a
    scatter's rows by owning shard (a scatter whose rows all land on one
    shard passes the ORIGINAL request through untouched — the S=1 bitwise
    parity lever); ``ScatterJoin`` reassembles the per-shard result slices in
    row order and completes at ``max`` of the part completions plus one
    ``CostModel.shard_merge_s`` collective when more than one shard
    contributed — the all_gather + top_k merge idiom of
    ``repro_torch.velo.dist_search``, lifted into the coroutine engine (and with
    the same masking discipline: a shard only ever contributes the rows it
    owns, so no sentinel row can win the merge).

The contract that keeps the plane honest (tests/test_sharding.py,
benchmarks/bench_sharded.py): with one shard the sharded engine is BITWISE
identical to the unsharded engine for all five algorithms, and QPS scales
near-linearly in shards at flat recall.  See docs/sharding.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import beam as beam_mod
from repro_torch.core import placement as placement_mod
from repro_torch.core.sim import SSD, SSDConfig


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The static data-placement half of the plane: who owns what."""

    n_shards: int
    page_shard: np.ndarray   # (n_pages,) int32 — owning shard per page
    vid_shard: np.ndarray    # (n,) int32 — owning shard per record

    def shards_of(self, vids) -> np.ndarray:
        """Owning shard of each vid (the scatter's routing vector)."""
        return self.vid_shard[np.asarray(vids, dtype=np.int64)]

    def shard_page_counts(self) -> np.ndarray:
        return np.bincount(
            self.page_shard.astype(np.int64), minlength=self.n_shards
        )


def plan_shards(
    vid_to_page: np.ndarray, n_pages: int, n_shards: int
) -> ShardPlan:
    """Build a plan from a layout's vid->page map: contiguous balanced page
    ranges (``placement.shard_pages``), vid ownership derived per page."""
    page_shard = placement_mod.shard_pages(n_pages, n_shards)
    vid_shard = page_shard[np.asarray(vid_to_page, dtype=np.int64)]
    return ShardPlan(
        n_shards=int(n_shards), page_shard=page_shard, vid_shard=vid_shard
    )


def plan_for_index(index, n_shards: int) -> ShardPlan:
    """Plan for either index family: VeloIndex keeps its map on ``layout``,
    FixedIndex carries ``vid_to_page`` directly."""
    layout = getattr(index, "layout", None)
    v2p = layout.vid_to_page if layout is not None else index.vid_to_page
    return plan_shards(np.asarray(v2p), int(index.store.n_pages), n_shards)


@dataclasses.dataclass
class ShardScatter:
    """Operand of the engine ``("scatter", ...)`` op: one score request plus
    the owning shard of each of its rows (``ShardPlan.shards_of`` of the
    frontier's vids — computed from LOCAL vids, before any serving-plane
    ``vid_base`` shift, so routing is independent of the table namespace)."""

    req: object                # distance.ScoreRequest
    shard_rows: np.ndarray     # (rows,) int32


class ScatterJoin:
    """Gather side of one scatter: collects per-shard result slices and
    reassembles them in row order.  ``remaining`` hits zero when every owning
    shard has dispatched its slice; the join then completes at the max part
    completion time plus one merge collective (multi-shard only)."""

    __slots__ = ("worker", "gen", "qid", "rows", "n_parts", "remaining",
                 "out", "direct", "t_done", "beam_req", "beam_parts")

    def __init__(self, worker, gen, qid, rows: int, n_parts: int,
                 beam_req=None):
        self.worker = worker
        self.gen = gen
        self.qid = qid
        self.rows = rows
        self.n_parts = n_parts
        self.remaining = n_parts
        self.out: np.ndarray | None = None
        self.direct = None       # single-part passthrough result
        self.t_done = 0.0
        # multi-shard beam scatter: the original BeamRequest (state + pending
        # inserts/marks) plus the per-shard local top-L (ids, dists) slices;
        # the engine finalizes via DistanceEngine.beam_finalize at merge time
        self.beam_req = beam_req
        self.beam_parts: list[tuple[np.ndarray, np.ndarray]] = []

    def put(self, ridx, val, t: float) -> bool:
        """Deliver one shard's slice; True when the join completed."""
        if ridx is None:
            self.direct = val    # the untouched original request's results
        elif self.beam_req is not None:
            self.beam_parts.append(val)   # (local ids, dists) of one shard
        else:
            if self.out is None:
                self.out = np.empty(self.rows, dtype=np.asarray(val).dtype)
            self.out[ridx] = val
        self.t_done = max(self.t_done, t)
        self.remaining -= 1
        return self.remaining == 0

    def merge(self):
        return self.direct if self.direct is not None else self.out

    def merge_beam_candidates(self) -> tuple[np.ndarray, np.ndarray]:
        """Global top-L over the union of the per-shard local top-Ls — the
        ``merge_topk`` half of the dist_search idiom.  Exact: every global
        top-L candidate is in its owning shard's local top-L, so the union
        contains the global answer and ranking by the (distance, id) tuple
        reproduces the single-shard step bitwise."""
        L = self.beam_req.state.L
        ids = np.concatenate([i for i, _ in self.beam_parts])
        ds = np.concatenate([d for _, d in self.beam_parts])
        order = np.lexsort((ids, ds))[:L]
        return ids[order], ds[order]


class ShardRouter:
    """Per-run engine-shard runtime: clocks, SSDs, rendezvous buffers.

    Fresh per run (like the engine's SSD): shard clocks start at zero and the
    per-shard devices start idle.  The engine owns all scheduling decisions —
    the router only holds state and the split/join mechanics."""

    def __init__(self, plan: ShardPlan, ssd_config: SSDConfig | None = None):
        self.plan = plan
        n = plan.n_shards
        self.ssds = [SSD(ssd_config) for _ in range(n)]
        self.shard_t = [0.0] * n
        self.pending: list[list] = [[] for _ in range(n)]
        self.pending_rows = [0] * n

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    def ssd_for_page(self, pid: int) -> SSD:
        return self.ssds[int(self.plan.page_shard[pid])]

    def has_pending(self) -> bool:
        # test the queues, NOT the row counts: a fused beam step may park
        # with zero fresh rows (pending-inserts-only — e.g. Starling's
        # refined admissions between reads), and the stall flush must still
        # see that join or the scheduler exits with its coroutine parked
        return any(self.pending)

    def split(self, sc: ShardScatter) -> list:
        """Partition a scatter's rows by owning shard: ``[(shard, subrequest,
        row_indices), ...]`` in ascending shard order.  When ONE shard owns
        every row the original request passes through untouched (row_indices
        None) — sub-request results are then bitwise the unsharded results,
        which is what makes the S=1 parity contract hold to the last bit."""
        req = sc.req
        shards = np.asarray(sc.shard_rows)
        if req.rows == 0 or shards.size == 0:
            return [(0, req, None)]
        first = int(shards[0])
        if bool((shards == first).all()):
            return [(first, req, None)]
        if isinstance(req, beam_mod.BeamRequest):
            # multi-shard beam step: each owning shard scores its slice of
            # the fresh frontier on LOCAL ids and returns its local top-L
            # (mask before translation — vid_base applies only at the
            # gather); the join merges and the engine finalizes against the
            # request's resident state
            parts = []
            fresh = np.asarray(req.fresh, dtype=np.int64)
            for s in range(self.plan.n_shards):
                ridx = np.flatnonzero(shards == s)
                if ridx.size == 0:
                    continue
                sub = beam_mod.BeamShardPart(
                    kind=req.kind,
                    pq=req.pq,
                    query=req.query,
                    vectors=(None if req.vectors is None
                             else np.asarray(req.vectors)[ridx]),
                    ids=fresh[ridx],
                    rows=int(ridx.size),
                    flop_s=req.flop_s * (ridx.size / req.rows),
                    L=req.state.L,
                    qb=req.qb,
                    tenant=req.tenant,
                    vid_base=req.vid_base,
                )
                parts.append((s, sub, ridx))
            return parts
        parts = []
        for s in range(self.plan.n_shards):
            ridx = np.flatnonzero(shards == s)
            if ridx.size == 0:
                continue
            payload = req.payload
            if isinstance(payload, tuple):
                # materialized (codes, lo, step) host-gather wire format
                payload = tuple(np.asarray(a)[ridx] for a in payload)
            else:
                payload = np.asarray(payload)[ridx]
            sub = dataclasses.replace(
                req,
                rows=int(ridx.size),
                flop_s=req.flop_s * (ridx.size / req.rows),
                payload=payload,
            )
            parts.append((s, sub, ridx))
        return parts

    def make_join(self, worker, gen, qid, rows: int, n_parts: int,
                  beam_req=None) -> ScatterJoin:
        return ScatterJoin(worker, gen, qid, rows, n_parts, beam_req=beam_req)
