"""The batched distance plane: pluggable DistanceEngine backends.

Every level-1 (binary estimate) and level-2 (extended-code / fp32 refinement)
distance evaluated by the search plane goes through one of these engines:

  * ``scalar`` — per-row NumPy loop.  Deliberately naive: it is the oracle the
    other backends are tested against, and the "before" point of the paper's
    batching argument (one distance per call, no SIMD amortization).
  * ``batch``  — vectorized NumPy over whole code matrices.  One BLAS/ufunc
    dispatch per frontier batch instead of per vertex.
  * ``torch``  — the hand-written CUDA kernels (kernels/binary_ip,
    kernels/int4_dist) on the card; the process default.  On a CPU device
    (``set_default_device("cpu")`` or ``get_engine(..., device="cpu")``) the
    kernels' plain PyTorch versions run instead.  There is no fallback: with
    no card and no explicit CPU device, ``get_engine("torch")`` raises.

Selection:

  get_engine("scalar" | "batch" | "torch" | "default" | None, device=...)

``default`` (and None) resolve to the process-wide default set with
``set_default_backend``.

Resident code plane (register-once tables):

Engines do not consume caller-gathered code matrices on the hot path.
``register_index(qb)`` pins an index's resident tables ONCE per engine —
contiguous host views (``quant.ResidentView``) for the NumPy backends,
tensors moved to the device with ``.to(device)`` for the torch backend — and
every id-based request gathers from the registered table: inside the kernels'
row loads for ``torch``, one fancy-index per table for the host backends.
Registration is lazy (first id-based call registers) and idempotent;
``DistanceStats.uploads`` counts table uploads so callers can assert they are
O(1) per index rather than O(hops).  The matrix-consuming entry points
(``refine`` over payload rows, the ``*_many`` matrix hooks) remain for the
host-gather parity path and for ext_bits=8 records — on the torch backend
each such call moves its gathered rows to the device and is counted as an
upload.

All engines consume the same packed artifact formats produced by
``RabitQuantizer.fit_encode`` (bit-packed level-1 codes, nibble-packed level-2
codes), so the host plane, the simulator, and the device kernels share one
index image.  Each engine keeps per-instance counters (``DistanceStats``) so
callers can report how much work the plane absorbed per batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import beam as beam_mod
from repro_torch.core.quant import (
    PreparedQuery,
    QuantizedBase,
    RabitQuantizer,
    ResidentView,
    unpack_bits,
)
from repro_torch.device import default_device, resolve_device, set_default_device  # noqa: F401
from repro_torch.kernels.binary_ip import estimate_dist2
from repro_torch.kernels.int4_dist import int4_dist2

BACKENDS = ("scalar", "batch", "torch")

_DEFAULT_BACKEND = "torch"

_EXECUTE = tracing.name("distance.execute")
_H2D = tracing.name("distance.h2d")  # contiguous copy, from_numpy, pageable .to
_D2H = tracing.name("distance.d2h")  # the wait for queued kernels, the copy back


def set_default_backend(name: str) -> None:
    """Set the process-wide default backend (see ``get_engine``)."""
    global _DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown distance backend {name!r}; expected {BACKENDS}")
    _DEFAULT_BACKEND = name


def default_backend() -> str:
    return _DEFAULT_BACKEND


@dataclasses.dataclass
class DistanceStats:
    """Work counters: calls vs rows show the batching amortization factor."""

    level1_calls: int = 0
    level1_rows: int = 0
    level2_calls: int = 0
    level2_rows: int = 0
    full_calls: int = 0
    full_rows: int = 0
    # cross-query fusion: dispatches that served >1 query's rows at once
    fused_calls: int = 0
    fused_queries: int = 0
    # resident code plane: table uploads (register_index, plus one per
    # gathered-row kernel call on the non-resident torch path) and rows
    # gathered from registered tables instead of caller-materialized matrices
    uploads: int = 0
    resident_gathers: int = 0
    # HBM record-cache tier: rows refined by slot-indirection gathers from
    # device cache slots (zero per-hop upload, like the resident table path)
    slot_gathers: int = 0
    # fused on-device beam steps: score + visited mask + top-k merge +
    # frontier select executed engine-side (the reply is a frontier, not a
    # per-row distance download)
    beam_steps: int = 0
    beam_rows: int = 0
    # the torch engine's host <-> device copies: tensors moved to the device
    # (query stacks, id vectors, beam state) and results moved back
    h2d_copies: int = 0
    d2h_copies: int = 0

    def dispatches(self) -> int:
        """Total kernel/ufunc dispatches issued by this engine instance."""
        return self.level1_calls + self.level2_calls + self.full_calls

    def rows_per_call(self) -> float:
        calls = self.dispatches()
        rows = self.level1_rows + self.level2_rows + self.full_rows
        return rows / calls if calls else 0.0


@dataclasses.dataclass
class ScoreRequest:
    """One coroutine's distance work, yielded to the engine as a ("score", req)
    op.  The engine collects requests from all ready coroutines — on one
    worker, or system-wide with the shared rendezvous — into a rendezvous
    buffer and executes them as ONE fused DistanceEngine call per kind (see
    ``execute_requests``), resuming each coroutine with its slice of the
    results.

    kinds:
      "estimate" — level-1 binary estimates; payload = vertex-id array
                   (rows resolved against the engine's registered tables)
      "refine"   — level-2 extended-code refinement; payload = vertex-id
                   array (resident path, the default), or a materialized
                   (codes, lo, step) tuple (host-gather parity path)
      "full"     — exact fp32 distances; payload = (m, d) vector matrix
    ``flop_s`` is the per-row arithmetic cost in simulated seconds (WITHOUT the
    dispatch overhead — the engine charges one amortized dispatch per flush).

    ``qb`` names the quantized table the id payload indexes (the tenant tag of
    the multi-tenant serving plane): requests from different indexes sharing
    one engine each carry their own table, and ``execute_requests`` routes
    each (kind, table) group to its own fused call.  ``qb=None`` falls back to
    the engine-level default — the single-system wire format, bitwise
    unchanged.  ``tenant`` is a purely diagnostic tag (``WorkloadStats.
    cross_tenant_flushes`` counts flushes spanning more than one).
    """

    kind: str
    rows: int
    flop_s: float
    pq: object = None                 # PreparedQuery ("estimate" / "refine")
    payload: object = None
    query: np.ndarray | None = None   # fp32 query vector ("full")
    qb: object = None                 # QuantizedBase the ids resolve against
                                      # (None -> engine default; serving plane
                                      # sets the tenant's registered table)
    tenant: int = 0                   # serving-plane tenant id (diagnostic)


class DistanceEngine:
    """Base class: counters + empty-batch handling + the register-once table
    registry; subclasses implement the kernels over registered tables and
    packed matrices."""

    name = "abstract"

    def __init__(self, resident: bool = True):
        self.stats = DistanceStats()
        # resident=False keeps the host-gather semantics on the torch path:
        # rows are gathered on the host and re-uploaded per call (the "before" point
        # the uploads counter quantifies).  Host backends gather from the
        # registered views either way — results are bitwise identical.
        self.resident = resident
        self._tables: dict[int, object] = {}

    # ---- register-once resident tables -------------------------------------
    def register_index(self, qb: QuantizedBase):
        """Pin ``qb``'s resident tables on this engine (idempotent).  Returns
        the table handle; the first registration counts one upload."""
        tbl = self._tables.get(id(qb))
        if tbl is None:
            tbl = self._build_table(qb)
            self._tables[id(qb)] = tbl
            self.stats.uploads += 1
        return tbl

    def is_registered(self, qb: QuantizedBase) -> bool:
        return id(qb) in self._tables

    def _build_table(self, qb: QuantizedBase):
        return ResidentView.from_qb(qb)

    # ---- level 1: binary estimate ------------------------------------------
    def estimate(
        self, qb: QuantizedBase, pq: PreparedQuery, ids: np.ndarray
    ) -> np.ndarray:
        """Level-1 estimated squared distances for vertex ids (resident codes)."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.empty(0, dtype=np.float32)
        tbl = self.register_index(qb)
        self.stats.level1_calls += 1
        self.stats.level1_rows += ids.size
        self.stats.resident_gathers += ids.size
        return self._estimate_ids(qb, tbl, pq, ids)

    # ---- level 2: extended-code refinement ---------------------------------
    def refine_ids(
        self, qb: QuantizedBase, pq: PreparedQuery, ids: np.ndarray
    ) -> np.ndarray:
        """Level-2 refined squared distances for vertex ids, served from the
        registered extended-code table (resident path)."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.empty(0, dtype=np.float32)
        tbl = self.register_index(qb)
        self.stats.level2_calls += 1
        self.stats.level2_rows += ids.size
        self.stats.resident_gathers += ids.size
        return self._refine_ids(qb, tbl, pq, ids)

    def refine(
        self,
        qb: QuantizedBase,
        pq: PreparedQuery,
        codes: np.ndarray,
        lo: np.ndarray,
        step: np.ndarray,
    ) -> np.ndarray:
        """Level-2 refined squared distances from packed extended codes
        (host-gather path: the caller materialized the rows)."""
        if codes.shape[0] == 0:
            return np.empty(0, dtype=np.float32)
        self.stats.level2_calls += 1
        self.stats.level2_rows += codes.shape[0]
        return self._refine(qb, pq, codes, lo, step)

    def refine_slots(
        self, view, pq: PreparedQuery, slots: np.ndarray
    ) -> np.ndarray:
        """Level-2 refinement by HBM cache SLOT index: rows gather from the
        tier's slot arrays (``cache_ext``/``cache_lo``/``cache_step``) rather
        than the per-vid registered table — the slot-indirection sibling of
        ``refine_ids``.  ``view`` is the tier handle (``core.hbm.HbmTier`` or
        any object with ``qb``, ``gather(slots)`` and, for the device
        backends, ``device_arrays(device)``)."""
        slots = np.asarray(slots, dtype=np.int64)
        if slots.size == 0:
            return np.empty(0, dtype=np.float32)
        self.stats.level2_calls += 1
        self.stats.level2_rows += slots.size
        self.stats.slot_gathers += slots.size
        return self._refine_slots(view, pq, slots)

    def refine_slots_many(
        self, view, groups: list[tuple[PreparedQuery, np.ndarray]]
    ) -> list[np.ndarray]:
        """Fused slot-based level-2 refinement: ``groups`` is (pq, slots)."""
        outs: list = [None] * len(groups)
        live: list[tuple[int, PreparedQuery, np.ndarray]] = []
        for i, (pq, slots) in enumerate(groups):
            slots = np.asarray(slots, dtype=np.int64)
            if slots.size == 0:
                outs[i] = np.empty(0, dtype=np.float32)
            else:
                live.append((i, pq, slots))
        if not live:
            return outs
        if len(live) == 1:
            i, pq, slots = live[0]
            outs[i] = self.refine_slots(view, pq, slots)
            return outs
        sizes = [slots.size for _, _, slots in live]
        all_slots = np.concatenate([slots for _, _, slots in live])
        self.stats.level2_calls += 1
        self.stats.level2_rows += all_slots.size
        self.stats.slot_gathers += all_slots.size
        self.stats.fused_calls += 1
        self.stats.fused_queries += len(live)
        res = self._refine_slots_many(
            view, [pq for _, pq, _ in live], sizes, all_slots
        )
        off = 0
        for (i, _, _), m in zip(live, sizes):
            outs[i] = np.asarray(res[off : off + m], dtype=np.float32)
            off += m
        return outs

    # ---- exact fp32 (DiskANN-style records, in-memory oracle) --------------
    def refine_full(self, q: np.ndarray, vectors: np.ndarray) -> np.ndarray:
        """Exact squared distances from full fp32 vectors to query ``q``."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[0] == 0:
            return np.empty(0, dtype=np.float32)
        self.stats.full_calls += 1
        self.stats.full_rows += vectors.shape[0]
        return self._refine_full(np.asarray(q, dtype=np.float32), vectors)

    # ---- fused multi-query dispatch ----------------------------------------
    # The cross-query batching plane: each method serves SEVERAL queries'
    # row groups in ONE dispatch (one stats "call").  Single-group batches
    # delegate to the per-query path, so a rendezvous of one is bitwise
    # identical to unfused execution.

    def estimate_many(
        self, qb: QuantizedBase, groups: list[tuple[PreparedQuery, np.ndarray]]
    ) -> list[np.ndarray]:
        """Fused level-1 estimates: ``groups`` is (pq, ids) per query; returns
        the per-query estimate arrays, order preserved."""
        outs: list = [None] * len(groups)
        live: list[tuple[int, PreparedQuery, np.ndarray]] = []
        for i, (pq, ids) in enumerate(groups):
            ids = np.asarray(ids, dtype=np.int64)
            if ids.size == 0:
                outs[i] = np.empty(0, dtype=np.float32)
            else:
                live.append((i, pq, ids))
        if not live:
            return outs
        if len(live) == 1:
            i, pq, ids = live[0]
            outs[i] = self.estimate(qb, pq, ids)
            return outs
        tbl = self.register_index(qb)
        sizes = [ids.size for _, _, ids in live]
        all_ids = np.concatenate([ids for _, _, ids in live])
        self.stats.level1_calls += 1
        self.stats.level1_rows += all_ids.size
        self.stats.resident_gathers += all_ids.size
        self.stats.fused_calls += 1
        self.stats.fused_queries += len(live)
        res = self._estimate_ids_many(
            qb, tbl, [pq for _, pq, _ in live], sizes, all_ids
        )
        off = 0
        for (i, _, _), m in zip(live, sizes):
            outs[i] = np.asarray(res[off : off + m], dtype=np.float32)
            off += m
        return outs

    def refine_ids_many(
        self, qb: QuantizedBase, groups: list[tuple[PreparedQuery, np.ndarray]]
    ) -> list[np.ndarray]:
        """Fused id-based level-2 refinement: ``groups`` is (pq, ids)."""
        outs: list = [None] * len(groups)
        live: list[tuple[int, PreparedQuery, np.ndarray]] = []
        for i, (pq, ids) in enumerate(groups):
            ids = np.asarray(ids, dtype=np.int64)
            if ids.size == 0:
                outs[i] = np.empty(0, dtype=np.float32)
            else:
                live.append((i, pq, ids))
        if not live:
            return outs
        if len(live) == 1:
            i, pq, ids = live[0]
            outs[i] = self.refine_ids(qb, pq, ids)
            return outs
        tbl = self.register_index(qb)
        sizes = [ids.size for _, _, ids in live]
        all_ids = np.concatenate([ids for _, _, ids in live])
        self.stats.level2_calls += 1
        self.stats.level2_rows += all_ids.size
        self.stats.resident_gathers += all_ids.size
        self.stats.fused_calls += 1
        self.stats.fused_queries += len(live)
        res = self._refine_ids_many(
            qb, tbl, [pq for _, pq, _ in live], sizes, all_ids
        )
        off = 0
        for (i, _, _), m in zip(live, sizes):
            outs[i] = np.asarray(res[off : off + m], dtype=np.float32)
            off += m
        return outs

    def refine_many(
        self,
        qb: QuantizedBase,
        groups: list[tuple[PreparedQuery, np.ndarray, np.ndarray, np.ndarray]],
    ) -> list[np.ndarray]:
        """Fused level-2 refinement over materialized rows: ``groups`` is
        (pq, codes, lo, step) — the host-gather parity path."""
        outs: list = [None] * len(groups)
        live = []
        for i, g in enumerate(groups):
            if g[1].shape[0] == 0:
                outs[i] = np.empty(0, dtype=np.float32)
            else:
                live.append((i, g))
        if not live:
            return outs
        if len(live) == 1:
            i, (pq, codes, lo, step) = live[0]
            outs[i] = self.refine(qb, pq, codes, lo, step)
            return outs
        sizes = [g[1].shape[0] for _, g in live]
        codes = np.concatenate([g[1] for _, g in live])
        lo = np.concatenate([g[2] for _, g in live])
        step = np.concatenate([g[3] for _, g in live])
        self.stats.level2_calls += 1
        self.stats.level2_rows += codes.shape[0]
        self.stats.fused_calls += 1
        self.stats.fused_queries += len(live)
        res = self._refine_many(qb, [g[0] for _, g in live], sizes, codes, lo, step)
        off = 0
        for (i, _), m in zip(live, sizes):
            outs[i] = np.asarray(res[off : off + m], dtype=np.float32)
            off += m
        return outs

    def refine_full_many(
        self, groups: list[tuple[np.ndarray, np.ndarray]]
    ) -> list[np.ndarray]:
        """Fused exact-fp32 refinement: ``groups`` is (q, vectors)."""
        outs: list = [None] * len(groups)
        live = []
        for i, (q, vectors) in enumerate(groups):
            vectors = np.asarray(vectors, dtype=np.float32)
            if vectors.shape[0] == 0:
                outs[i] = np.empty(0, dtype=np.float32)
            else:
                live.append((i, np.asarray(q, dtype=np.float32), vectors))
        if not live:
            return outs
        if len(live) == 1:
            i, q, vectors = live[0]
            outs[i] = self.refine_full(q, vectors)
            return outs
        sizes = [v.shape[0] for _, _, v in live]
        vectors = np.concatenate([v for _, _, v in live])
        self.stats.full_calls += 1
        self.stats.full_rows += vectors.shape[0]
        self.stats.fused_calls += 1
        self.stats.fused_queries += len(live)
        res = self._refine_full_many([q for _, q, _ in live], sizes, vectors)
        off = 0
        for (i, _, _), m in zip(live, sizes):
            outs[i] = np.asarray(res[off : off + m], dtype=np.float32)
            off += m
        return outs

    # ---- fused beam step: score -> visited mask -> top-k -> frontier -------
    # The reply to a beam op is the next FRONTIER, not a distance download:
    # the per-query candidate heap and visited/explored masks stay engine-
    # resident across hops (device tensors on the torch backend).  Scoring
    # routes through the same estimate/full machinery as the host path, so
    # distances are bitwise identical to a ("score", ...) op; the merge and
    # frontier selection follow the (d, v)-tuple order of the host _Beam.

    def beam_new(self, L: int, n: int) -> beam_mod.BeamState:
        """Fresh engine-resident beam state for one query (L-slot candidate
        heap over an n-vertex id space)."""
        return beam_mod.BeamState.new(L, n)

    def beam_step(self, qb, req: beam_mod.BeamRequest) -> beam_mod.BeamResult:
        """One fused beam step (see ``beam_step_many``)."""
        return self.beam_step_many(qb, [req])[0]

    def beam_step_many(
        self, qb, reqs: list[beam_mod.BeamRequest]
    ) -> list[beam_mod.BeamResult]:
        """Fused beam steps for a rendezvous group of queries: score each
        request's fresh ids, drop visited, merge into its candidate heap,
        mark explored, and select its next frontier — one launch for the
        whole group on the device backend."""
        self.stats.beam_steps += len(reqs)
        self.stats.beam_rows += sum(int(r.rows) for r in reqs)
        return self._beam_step_many(qb, reqs)

    def _beam_step_many(self, qb, reqs):
        scores = self._beam_scores(qb, reqs)
        return [self._beam_apply(r, s) for r, s in zip(reqs, scores)]

    def _beam_scores(self, qb, reqs) -> list[np.ndarray]:
        """Fresh-id distances per request, via the engine's own fused score
        paths (bitwise the values a ("score", ...) op would have returned)."""
        scores: list = [None] * len(reqs)

        def ids_of(r):  # BeamRequest carries .fresh, BeamShardPart .ids
            return r.fresh if isinstance(r, beam_mod.BeamRequest) else r.ids

        subgroups: dict[tuple, list[int]] = {}
        for i, r in enumerate(reqs):
            gqb = r.qb if r.qb is not None else qb
            subgroups.setdefault((r.kind, id(gqb)), []).append(i)
        for (kind, _), idxs in subgroups.items():
            if kind == "estimate":
                gqb = reqs[idxs[0]].qb if reqs[idxs[0]].qb is not None else qb
                res = self.estimate_many(gqb, [
                    (reqs[i].pq,
                     np.asarray(ids_of(reqs[i]), np.int64) + reqs[i].vid_base)
                    for i in idxs
                ])
            elif kind == "full":
                res = self.refine_full_many([
                    (reqs[i].query, reqs[i].vectors) for i in idxs
                ])
            else:
                raise ValueError(f"unknown beam request kind {kind!r}")
            for i, s in zip(idxs, res):
                scores[i] = s
        return scores

    def _beam_apply(
        self, req: beam_mod.BeamRequest, fresh_d: np.ndarray
    ) -> beam_mod.BeamResult:
        """Reference (vectorized NumPy) mask/merge/select over one state."""
        st = req.state
        cand_d, cand_v, visited, explored = self._beam_host_view(st)
        cv = np.concatenate([
            np.asarray(req.fresh, np.int64),
            np.asarray(req.insert_ids, np.int64),
        ])
        cd = np.concatenate([
            np.asarray(fresh_d, np.float32),
            np.asarray(req.insert_ds, np.float32),
        ])
        # first-wins within the step, then the visited bitmask — the host
        # _Beam.insert early-return semantics
        keep = beam_mod.dedupe_first(cv) & ~beam_mod.mask_ids(visited, cv)
        cv, cd = cv[keep], cd[keep]
        beam_mod.set_ids(visited, cv)
        cand_d, cand_v = beam_mod.merge_topk(cand_d, cand_v, cd, cv, st.L)
        expl = np.asarray(req.explored, np.int64)
        if expl.size:
            beam_mod.set_ids(explored, expl)
        self._beam_store(st, cand_d, cand_v, visited, explored)
        frontier, wlen, tail = beam_mod.select_frontier(cand_d, cand_v, explored)
        res = beam_mod.BeamResult(frontier=frontier, window_len=wlen, tail=tail)
        if req.topk:
            k = min(int(req.topk), st.L)
            real = cand_v[:k] != beam_mod.PAD_VID
            res.topk_ids = cand_v[:k][real]
            res.topk_ds = cand_d[:k][real]
        return res

    def _beam_host_view(self, st: beam_mod.BeamState):
        return st.cand_d, st.cand_v, st.visited, st.explored

    def _beam_store(self, st, cand_d, cand_v, visited, explored):
        st.cand_d, st.cand_v = cand_d, cand_v
        st.visited, st.explored = visited, explored

    # ---- sharded beam: local top-k per shard, global merge at the join -----

    def beam_score_local(self, qb, part: beam_mod.BeamShardPart):
        return self.beam_score_local_many(qb, [part])[0]

    def beam_score_local_many(
        self, qb, parts: list[beam_mod.BeamShardPart]
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Score each shard part's LOCAL ids and return its local top-L
        (ids, dists) — the ``dist_search`` mask-local-topk idiom: ranking
        happens on local ids (mask BEFORE translation); ``vid_base`` is
        applied only for the table gather.  The engine merges the per-shard
        slices at the scatter join (``beam_finalize``); the union of local
        top-Ls contains the global top-L, so the result is bitwise the
        single-shard step."""
        scores = self._beam_scores(qb, parts)
        outs = []
        for p, ds in zip(parts, scores):
            ids = np.asarray(p.ids, np.int64)
            ds = np.asarray(ds, np.float32)
            order = np.lexsort((ids, ds))[: p.L]
            outs.append((ids[order], ds[order]))
        return outs

    def beam_finalize(
        self, qb, req: beam_mod.BeamRequest,
        ids: np.ndarray, ds: np.ndarray,
    ) -> beam_mod.BeamResult:
        """Fold the globally merged candidates of a multi-shard beam scatter
        into the request's state (no scoring — the shards already did it) and
        select the frontier, applying the request's pending inserts and
        explored marks exactly once."""
        self.stats.beam_steps += 1
        self.stats.beam_rows += int(np.asarray(ids).size)
        sub = dataclasses.replace(req, fresh=np.asarray(ids, np.int64))
        return self._beam_apply(sub, np.asarray(ds, np.float32))

    # ---- id-based hooks over registered tables -----------------------------
    # Defaults gather the rows from the registered host view and delegate to
    # the matrix hooks — bitwise identical to a caller-side gather.  The
    # torch backend overrides them to gather inside the kernels instead.

    def _estimate_ids(self, qb, tbl: ResidentView, pq, ids) -> np.ndarray:
        codes, norms, ip_bar = tbl.gather_level1(ids)
        return self._estimate(qb, pq, codes, norms, ip_bar)

    def _refine_ids(self, qb, tbl: ResidentView, pq, ids) -> np.ndarray:
        codes, lo, step = tbl.gather_level2(ids)
        return self._refine(qb, pq, codes, lo, step)

    def _estimate_ids_many(self, qb, tbl: ResidentView, pqs, sizes, ids) -> np.ndarray:
        codes, norms, ip_bar = tbl.gather_level1(ids)
        return self._estimate_many(qb, pqs, sizes, codes, norms, ip_bar)

    def _refine_ids_many(self, qb, tbl: ResidentView, pqs, sizes, ids) -> np.ndarray:
        codes, lo, step = tbl.gather_level2(ids)
        return self._refine_many(qb, pqs, sizes, codes, lo, step)

    # ---- slot-based hooks over HBM cache slot arrays -----------------------
    # Defaults gather the slot rows on the host and delegate to the matrix
    # hooks; the torch backend overrides them to gather from the tier's
    # device mirror instead (zero upload — the slot-gather kernel path).

    def _refine_slots(self, view, pq, slots) -> np.ndarray:
        codes, lo, step = view.gather(slots)
        return self._refine(view.qb, pq, codes, lo, step)

    def _refine_slots_many(self, view, pqs, sizes, slots) -> np.ndarray:
        codes, lo, step = view.gather(slots)
        return self._refine_many(view.qb, pqs, sizes, codes, lo, step)

    # ---- subclass hooks ----------------------------------------------------
    def _estimate(self, qb, pq, codes, norms, ip_bar) -> np.ndarray:
        raise NotImplementedError

    def _refine(self, qb, pq, codes, lo, step) -> np.ndarray:
        raise NotImplementedError

    def _refine_full(self, q, vectors) -> np.ndarray:
        raise NotImplementedError

    # Fused-dispatch hooks.  The defaults evaluate per query group over the
    # stacked matrices (correct everywhere, fused only in accounting); the
    # batch/torch backends override them with genuinely fused evaluations.
    def _estimate_many(self, qb, pqs, sizes, codes, norms, ip_bar) -> np.ndarray:
        out = np.empty(codes.shape[0], dtype=np.float32)
        off = 0
        for pq, m in zip(pqs, sizes):
            out[off : off + m] = self._estimate(
                qb, pq, codes[off : off + m], norms[off : off + m],
                ip_bar[off : off + m],
            )
            off += m
        return out

    def _refine_many(self, qb, pqs, sizes, codes, lo, step) -> np.ndarray:
        out = np.empty(codes.shape[0], dtype=np.float32)
        off = 0
        for pq, m in zip(pqs, sizes):
            out[off : off + m] = self._refine(
                qb, pq, codes[off : off + m], lo[off : off + m],
                step[off : off + m],
            )
            off += m
        return out

    def _refine_full_many(self, qs, sizes, vectors) -> np.ndarray:
        out = np.empty(vectors.shape[0], dtype=np.float32)
        off = 0
        for q, m in zip(qs, sizes):
            out[off : off + m] = self._refine_full(q, vectors[off : off + m])
            off += m
        return out


class ScalarEngine(DistanceEngine):
    """One row at a time — the oracle and the pre-batching cost baseline."""

    name = "scalar"

    def _estimate(self, qb, pq, codes, norms, ip_bar):
        out = np.empty(codes.shape[0], dtype=np.float32)
        for i in range(codes.shape[0]):
            out[i] = RabitQuantizer.estimate_batch(
                qb, pq, codes[i : i + 1], norms[i : i + 1], ip_bar[i : i + 1]
            )[0]
        return out

    def _refine(self, qb, pq, codes, lo, step):
        out = np.empty(codes.shape[0], dtype=np.float32)
        for i in range(codes.shape[0]):
            out[i] = RabitQuantizer.refine_batch(
                qb, pq, codes[i : i + 1], lo[i : i + 1], step[i : i + 1]
            )[0]
        return out

    def _refine_full(self, q, vectors):
        out = np.empty(vectors.shape[0], dtype=np.float32)
        for i in range(vectors.shape[0]):
            diff = vectors[i] - q
            out[i] = diff @ diff
        return out

    def _beam_apply(self, req, fresh_d):
        # Literal insort oracle, independently implemented from the
        # vectorized merge — the property-test reference, written the way
        # the host _Beam maintains its list.
        import bisect

        st = req.state
        _, _, visited, explored = self._beam_host_view(st)
        items = [
            (float(d), int(v))
            for d, v in zip(st.cand_d, st.cand_v)
            if v != beam_mod.PAD_VID
        ]
        pairs = list(zip(np.asarray(req.fresh, np.int64),
                         np.asarray(fresh_d, np.float32)))
        pairs += list(zip(np.asarray(req.insert_ids, np.int64),
                          np.asarray(req.insert_ds, np.float32)))
        for v, d in pairs:
            v = int(v)
            if visited[v]:
                continue
            visited[v] = True
            bisect.insort(items, (float(np.float32(d)), v))
        items = items[: st.L]
        cand_d = np.full(st.L, beam_mod.INF, dtype=np.float32)
        cand_v = np.full(st.L, beam_mod.PAD_VID, dtype=np.int64)
        for i, (d, v) in enumerate(items):
            cand_d[i], cand_v[i] = d, v
        for v in np.asarray(req.explored, np.int64):
            explored[int(v)] = True
        self._beam_store(st, cand_d, cand_v, visited, explored)
        frontier = np.asarray(
            [v for _, v in items if not explored[v]], dtype=np.int64
        )
        res = beam_mod.BeamResult(
            frontier=frontier, window_len=len(items), tail=float(cand_d[-1])
        )
        if req.topk:
            head = items[: min(int(req.topk), st.L)]
            res.topk_ids = np.asarray([v for _, v in head], dtype=np.int64)
            res.topk_ds = np.asarray([d for d, _ in head], dtype=np.float32)
        return res


class BatchEngine(DistanceEngine):
    """Vectorized NumPy over whole code matrices (default backend)."""

    name = "batch"

    def _estimate(self, qb, pq, codes, norms, ip_bar):
        return RabitQuantizer.estimate_batch(qb, pq, codes, norms, ip_bar).astype(
            np.float32, copy=False
        )

    def _refine(self, qb, pq, codes, lo, step):
        return RabitQuantizer.refine_batch(qb, pq, codes, lo, step).astype(
            np.float32, copy=False
        )

    def _refine_full(self, q, vectors):
        diff = vectors - q[None, :]
        return np.einsum("ij,ij->i", diff, diff).astype(np.float32, copy=False)

    # ---- genuinely fused multi-query paths ---------------------------------

    def _estimate_many(self, qb, pqs, sizes, codes, norms, ip_bar):
        # One GEMM over the stacked frontier rows of ALL queries: (M, d) signs
        # times (d, B) stacked unit queries; each row then selects its owner's
        # column — one dispatch serves B queries.
        d = qb.dim
        signs = 2.0 * unpack_bits(codes, d).astype(np.float32) - 1.0  # (M, d)
        Q = np.stack([pq.qunit for pq in pqs])                        # (B, d)
        owner = np.repeat(np.arange(len(pqs)), sizes)
        g = signs @ Q.T                                               # (M, B)
        g = g[np.arange(g.shape[0]), owner] / np.sqrt(d)
        est_cos = np.clip(g / np.maximum(ip_bar, 1e-6), -1.0, 1.0)
        qn = np.asarray([pq.qnorm for pq in pqs], dtype=np.float64)[owner]
        out = qn**2 + norms**2 - 2.0 * qn * norms * est_cos
        return out.astype(np.float32, copy=False)

    def _refine_many(self, qb, pqs, sizes, codes, lo, step):
        rec = qb.decode_ext(codes) * step[:, None] + lo[:, None]      # (M, d)
        owner = np.repeat(np.arange(len(pqs)), sizes)
        qr_rows = np.stack([pq.qr for pq in pqs])[owner]              # (M, d)
        diff = qr_rows - rec
        return (diff * diff).sum(axis=1).astype(np.float32, copy=False)

    def _refine_full_many(self, qs, sizes, vectors):
        owner = np.repeat(np.arange(len(qs)), sizes)
        diff = vectors - np.stack(qs)[owner]
        return np.einsum("ij,ij->i", diff, diff).astype(np.float32, copy=False)


_PAD_VID = int(beam_mod.PAD_VID)
_INF = float("inf")


def _beam_step(Q, tbl, ids, vid_base, fresh_len, ins_v, ins_d, ins_len, expl,
               cand_d, cand_v, visited, explored):
    """The fused beam step over B stacked query states, as PyTorch ops on the
    tables' device: score -> visited mask -> (dist, vid) merge -> frontier.

    ``ids`` (B, Fp), ``ins_v``/``ins_d`` (B, Ip) and ``expl`` (B, Ep) are
    lane-padded; ``*_len`` say how many lanes are real.  ``visited`` and
    ``explored`` are (B, n + 1) masks updated IN PLACE: the caller hands in
    freshly stacked copies, so no other request's state aliases them.
    Returns the merged (cand_d, cand_v), the frontier (-1 padded), the real
    window length and the slot L-1 tail per row.
    """
    B, Fp = ids.shape
    L = cand_d.shape[1]
    dev = ids.device
    sink = visited.shape[1] - 1  # pad-lane write target (slot n)
    rows_b = torch.arange(B, device=dev)[:, None]

    # -- score: one kernel launch gathers every query's fresh rows by id
    # where the table lives (pad lanes gather row vid_base, masked below)
    flat = (ids + vid_base[:, None]).reshape(-1)
    est = estimate_dist2(Q, tbl.binary_codes, tbl.norms, tbl.ip_bar, ids=flat)
    d_fresh = est.reshape(B, B, Fp)[torch.arange(B, device=dev), torch.arange(B, device=dev)]

    # -- visited-bitmask filter + first-wins dedupe over the step's
    # candidates (fresh rows first, then host-provided inserts)
    ok_f = torch.arange(Fp, device=dev)[None, :] < fresh_len[:, None]
    ok_i = torch.arange(ins_v.shape[1], device=dev)[None, :] < ins_len[:, None]
    cv = torch.cat([ids, ins_v], dim=1)
    cd = torch.cat([d_fresh, ins_d], dim=1)
    ok = torch.cat([ok_f, ok_i], dim=1)
    ok &= ~visited.gather(1, cv.clamp(max=sink))
    masked_v = torch.where(ok, cv, _PAD_VID)
    sv, perm = torch.sort(masked_v, dim=1, stable=True)  # lane order on ties
    dup_sorted = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=dev), sv[:, 1:] == sv[:, :-1]],
        dim=1,
    )
    ok &= ~torch.zeros_like(dup_sorted).scatter(1, perm, dup_sorted)

    # -- visited update (invalid lanes write the pad sink)
    visited[rows_b, torch.where(ok, cv, sink)] = True

    # -- top-k merge against the resident heap, ordered by the (distance,
    # vertex id) tuple: a stable sort by id, then a stable sort by distance,
    # is np.lexsort((v, d)) lane for lane (torch.topk has no tie contract)
    md = torch.cat([cand_d, torch.where(ok, cd, _INF)], dim=1)
    mv = torch.cat([cand_v, torch.where(ok, cv, _PAD_VID)], dim=1)
    _, by_v = torch.sort(mv, dim=1, stable=True)
    _, by_d = torch.sort(md.gather(1, by_v), dim=1, stable=True)
    order = by_v.gather(1, by_d)[:, :L]
    cand_d, cand_v = md.gather(1, order), mv.gather(1, order)

    # -- explored marks, then frontier = unexplored heap entries in heap
    # (ascending) order, stable-compacted to the front
    explored[rows_b, expl] = True
    real = cand_v != _PAD_VID
    live = real & ~explored.gather(1, cand_v.clamp(max=sink))
    rank, lanes = torch.sort((~live).to(torch.int8), dim=1, stable=True)
    frontier = torch.where(rank == 0, cand_v.gather(1, lanes), -1)
    return cand_d, cand_v, frontier, real.sum(dim=1), cand_d[:, L - 1]


class _DeviceTable:
    """Register-once device residency for one index: the level-1/level-2
    tables moved to the engine's device once with ``.to(device)``, plus the
    host view for the paths without a kernel (ext_bits=8, non-resident
    mode)."""

    __slots__ = ("host", "binary_codes", "norms", "ip_bar",
                 "ext_codes", "ext_lo", "ext_step")

    def __init__(self, qb: QuantizedBase, device: torch.device):
        self.host = ResidentView.from_qb(qb)
        for name in _DeviceTable.__slots__[1:]:
            arr = getattr(self.host, name)
            setattr(self, name, torch.from_numpy(arr).to(device))

    def gather_level1(self, ids):
        return self.host.gather_level1(ids)

    def gather_level2(self, ids):
        return self.host.gather_level2(ids)


def _owned(out: np.ndarray, sizes) -> np.ndarray:
    """Each stacked row's distance to its OWN query: column j of the fused
    (B, M) result belongs to the query whose group holds row j."""
    owner = np.repeat(np.arange(len(sizes)), sizes)
    return out[owner, np.arange(out.shape[1])].astype(np.float32, copy=False)


class TorchEngine(BatchEngine):
    """The hand-written CUDA kernels for both quantized levels.

    ``register_index`` moves the code tables to the device once per index;
    id-based requests ship only the id vector, and the kernels gather the
    rows through it where the table lives — no per-hop row upload.  Fused
    multi-query calls are one (B, N) launch sliced by owner.  The exact-fp32
    path and the 8-bit extended codes (no int4 kernel applies) stay on the
    NumPy batch path.  Tensors on the CPU take each kernel's plain PyTorch
    version, which is how the tests run this engine without a card.
    """

    name = "torch"

    def __init__(self, device: str | torch.device | None = None,
                 resident: bool = True):
        super().__init__(resident=resident)
        self.device = resolve_device(device)

    def _build_table(self, qb: QuantizedBase):
        if not self.resident:
            return ResidentView.from_qb(qb)  # host views only, rows re-upload
        return _DeviceTable(qb, self.device)

    # ---- host <-> device ---------------------------------------------------

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        self.stats.h2d_copies += 1
        sp = tracing.begin(_H2D) if tracing.on else -1
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if sp >= 0:
            tracing.end(sp)
        return t

    def _ids(self, ids) -> torch.Tensor:
        return self._put(np.asarray(ids, dtype=np.int64))

    def _queries(self, pqs) -> torch.Tensor:
        return self._put(np.stack([pq.qr for pq in pqs]).astype(np.float32, copy=False))

    def _host(self, t: torch.Tensor) -> np.ndarray:
        # the wait for the kernels queued before it, then the copy back
        self.stats.d2h_copies += 1
        sp = tracing.begin(_D2H) if tracing.on else -1
        out = t.cpu().numpy()
        if sp >= 0:
            tracing.end(sp)
        return out

    # ---- resident id-based paths: the kernels gather by id -----------------

    def _estimate_ids(self, qb, tbl, pq, ids):
        if not self.resident:
            return super()._estimate_ids(qb, tbl, pq, ids)
        out = estimate_dist2(self._queries([pq]), tbl.binary_codes, tbl.norms,
                             tbl.ip_bar, ids=self._ids(ids))
        return self._host(out)[0]

    def _refine_ids(self, qb, tbl, pq, ids):
        if not self.resident or qb.ext_bits != 4:
            # no int4 kernel for 8-bit codes: host gather + NumPy batch path
            return super()._refine_ids(qb, tbl, pq, ids)
        out = int4_dist2(self._queries([pq]), tbl.ext_codes, tbl.ext_lo,
                         tbl.ext_step, ids=self._ids(ids))
        return self._host(out)[0]

    def _estimate_ids_many(self, qb, tbl, pqs, sizes, ids):
        if not self.resident:
            return super()._estimate_ids_many(qb, tbl, pqs, sizes, ids)
        out = estimate_dist2(self._queries(pqs), tbl.binary_codes, tbl.norms,
                             tbl.ip_bar, ids=self._ids(ids))
        return _owned(self._host(out), sizes)

    def _refine_ids_many(self, qb, tbl, pqs, sizes, ids):
        if not self.resident or qb.ext_bits != 4:
            return super()._refine_ids_many(qb, tbl, pqs, sizes, ids)
        out = int4_dist2(self._queries(pqs), tbl.ext_codes, tbl.ext_lo,
                         tbl.ext_step, ids=self._ids(ids))
        return _owned(self._host(out), sizes)

    # ---- slot-based paths: gather from the tier's device mirror ------------
    # The slot-index vector is the only thing shipped per call; the slot
    # arrays were moved to the device once (and are maintained by the tier's
    # scatter), so — like the resident id path — these do NOT count uploads.

    def _refine_slots(self, view, pq, slots):
        if not self.resident or view.qb.ext_bits != 4:
            return super()._refine_slots(view, pq, slots)
        ext, lo, step = view.device_arrays(self.device)
        out = int4_dist2(self._queries([pq]), ext, lo, step, ids=self._ids(slots))
        return self._host(out)[0]

    def _refine_slots_many(self, view, pqs, sizes, slots):
        if not self.resident or view.qb.ext_bits != 4:
            return super()._refine_slots_many(view, pqs, sizes, slots)
        ext, lo, step = view.device_arrays(self.device)
        out = int4_dist2(self._queries(pqs), ext, lo, step, ids=self._ids(slots))
        return _owned(self._host(out), sizes)

    # ---- fused beam step: the device path ----------------------------------
    # The candidate heap and visited/explored masks live as device tensors
    # across hops; one ``_beam_step`` executes score -> mask -> merge ->
    # select, and the only download per step is the frontier (plus two
    # scalars per query).  The fp32 "full" kind and the non-resident mode
    # take the generic NumPy path via the host-view round-trip.

    def beam_new(self, L, n):
        st = beam_mod.BeamState.new(L, n)
        if self.resident:
            st.cand_d = self._put(st.cand_d)
            st.cand_v = self._put(st.cand_v)
            st.visited = self._put(st.visited)
            st.explored = self._put(st.explored)
            st.backend = "device"
        return st

    def _beam_host_view(self, st):
        if st.backend != "device":
            return super()._beam_host_view(st)
        # the generic path mutates the masks in place, and on the CPU
        # Tensor.numpy() aliases the tensor: hand it copies, never views
        self.stats.d2h_copies += 4
        sp = tracing.begin(_D2H) if tracing.on else -1
        out = tuple(
            t.cpu().numpy().copy()
            for t in (st.cand_d, st.cand_v, st.visited, st.explored)
        )
        if sp >= 0:
            tracing.end(sp)
        return out

    def _beam_store(self, st, cand_d, cand_v, visited, explored):
        if st.backend != "device":
            return super()._beam_store(st, cand_d, cand_v, visited, explored)
        st.cand_d = self._put(np.asarray(cand_d, dtype=np.float32).copy())
        st.cand_v = self._put(np.asarray(cand_v, dtype=np.int64).copy())
        st.visited = self._put(np.array(visited, dtype=bool))
        st.explored = self._put(np.array(explored, dtype=bool))

    def _beam_step_many(self, qb, reqs):
        gqb = reqs[0].qb if reqs[0].qb is not None else qb
        fusable = (
            self.resident
            and all(r.kind == "estimate" for r in reqs)
            and all((r.qb if r.qb is not None else qb) is gqb for r in reqs)
            and all(int(r.topk) == 0 for r in reqs)
            and all(r.state.backend == "device" for r in reqs)
            and len({(r.state.L, r.state.n) for r in reqs}) == 1
        )
        if not fusable:
            return super()._beam_step_many(qb, reqs)
        tbl = self.register_index(gqb)
        B = len(reqs)
        n = reqs[0].state.n

        fresh = [np.asarray(r.fresh, dtype=np.int64) for r in reqs]
        insv_l = [np.asarray(r.insert_ids, dtype=np.int64) for r in reqs]
        expl_l = [np.asarray(r.explored, dtype=np.int64) for r in reqs]
        Fp = max(1, max(f.size for f in fresh))
        Ip = max(1, max(v.size for v in insv_l))
        Ep = max(1, max(e.size for e in expl_l))
        ids = np.zeros((B, Fp), dtype=np.int64)
        flen = np.zeros(B, dtype=np.int64)
        insv = np.zeros((B, Ip), dtype=np.int64)
        insd = np.full((B, Ip), np.inf, dtype=np.float32)
        ilen = np.zeros(B, dtype=np.int64)
        expl = np.full((B, Ep), n, dtype=np.int64)  # pad lanes hit the sink
        vbase = np.zeros(B, dtype=np.int64)
        for i, r in enumerate(reqs):
            ids[i, : fresh[i].size] = fresh[i]
            flen[i] = fresh[i].size
            insv[i, : insv_l[i].size] = insv_l[i]
            insd[i, : insv_l[i].size] = np.asarray(r.insert_ds, np.float32)
            ilen[i] = insv_l[i].size
            expl[i, : expl_l[i].size] = expl_l[i]
            vbase[i] = int(r.vid_base)
        rows = int(flen.sum())
        if rows:  # merge-only steps (insert/mark flushes) score nothing
            self.stats.level1_calls += 1
            self.stats.level1_rows += rows
            self.stats.resident_gathers += rows
            if B > 1:
                self.stats.fused_calls += 1
                self.stats.fused_queries += B
        put = self._put
        # torch.stack copies: the in-place mask updates in _beam_step touch
        # no tensor that another request's state still reads
        visited = torch.stack([r.state.visited for r in reqs])
        explored = torch.stack([r.state.explored for r in reqs])
        cand_d, cand_v, frontier, wlen, tail = _beam_step(
            self._queries([r.pq for r in reqs]), tbl, put(ids), put(vbase),
            put(flen), put(insv), put(insd), put(ilen), put(expl),
            torch.stack([r.state.cand_d for r in reqs]),
            torch.stack([r.state.cand_v for r in reqs]),
            visited, explored,
        )
        # the ONE host<->device exchange per step: frontiers + two scalars
        frontier_np = self._host(frontier)
        wlen_np = self._host(wlen)
        tail_np = self._host(tail)
        out = []
        for i, r in enumerate(reqs):
            r.state.cand_d = cand_d[i]
            r.state.cand_v = cand_v[i]
            r.state.visited = visited[i]
            r.state.explored = explored[i]
            fr = frontier_np[i]
            out.append(beam_mod.BeamResult(
                frontier=fr[fr >= 0].astype(np.int64),
                window_len=int(wlen_np[i]),
                tail=float(tail_np[i]),
            ))
        return out

    # ---- matrix paths: caller-gathered rows, moved to the device per call --

    def _estimate(self, qb, pq, codes, norms, ip_bar):
        return self._estimate_many(qb, [pq], [codes.shape[0]], codes, norms, ip_bar)

    def _refine(self, qb, pq, codes, lo, step):
        if qb.ext_bits != 4:  # the kernel is nibble-packed int4 only
            return super()._refine(qb, pq, codes, lo, step)
        return self._refine_many(qb, [pq], [codes.shape[0]], codes, lo, step)

    # ---- fused multi-query paths: the kernels are (B, N)-shaped already ----

    def _estimate_many(self, qb, pqs, sizes, codes, norms, ip_bar):
        self.stats.uploads += 1  # gathered rows ship to the device this call
        out = estimate_dist2(self._queries(pqs), self._put(codes),
                             self._put(norms), self._put(ip_bar))
        return _owned(self._host(out), sizes)

    def _refine_many(self, qb, pqs, sizes, codes, lo, step):
        if qb.ext_bits != 4:  # no int4 kernel: NumPy fused path
            return super()._refine_many(qb, pqs, sizes, codes, lo, step)
        self.stats.uploads += 1
        out = int4_dist2(self._queries(pqs), self._put(codes), self._put(lo),
                         self._put(step))
        return _owned(self._host(out), sizes)


def get_engine(
    name: str | None = None, resident: bool = True,
    device: str | torch.device | None = None,
) -> DistanceEngine:
    """Build a fresh engine for ``name`` (see module docstring for the rules).
    ``resident=False`` keeps the host-gather semantics on the torch path
    (per-call row uploads) — the parity/ablation baseline.  ``device`` picks
    the torch engine's device (None: the process default, the CUDA card);
    the NumPy engines ignore it."""
    if name is None or name == "default":
        name = _DEFAULT_BACKEND
    if name == "scalar":
        return ScalarEngine(resident=resident)
    if name == "batch":
        return BatchEngine(resident=resident)
    if name == "torch":
        return TorchEngine(device=device, resident=resident)
    raise ValueError(f"unknown distance backend {name!r}; expected {BACKENDS}")


def request_group_key(req: ScoreRequest, default_qb: QuantizedBase | None):
    """The dispatch-group key of one score request: requests sharing a key are
    served by ONE fused engine call.  Quantized kinds group by (kind, table) —
    the serving plane's cross-index routing: ids from different registered
    tables cannot be gathered by one kernel launch, so each table gets its own
    dispatch (tenants sharing a combined table still fuse into one).  ``full``
    requests group by vector dimensionality so a cross-tenant flush never
    concatenates mismatched matrices.  Single-system runs have one table and
    one dim, so the grouping degenerates to one group per kind, bitwise.
    """
    if isinstance(req, beam_mod.BeamRequest):
        qb = req.qb if req.qb is not None else default_qb
        return ("beam", (req.kind, id(qb)))
    if isinstance(req, beam_mod.BeamShardPart):
        qb = req.qb if req.qb is not None else default_qb
        return ("beam_part", (req.kind, id(qb)))
    kind = req.kind
    if kind == "refine" and isinstance(req.payload, tuple):
        kind = "refine_rows"  # materialized host-gather wire format
    if kind == "full":
        return (kind, int(np.asarray(req.payload).shape[1]))
    qb = req.qb if req.qb is not None else default_qb
    return (kind, id(qb))


def execute_requests(
    engine: DistanceEngine, qb: QuantizedBase | None, reqs: list[ScoreRequest],
    hbm=None, splits: dict[int, tuple] | None = None,
) -> list[np.ndarray]:
    """Execute a rendezvous batch of score requests: ONE fused engine call per
    dispatch group present (``request_group_key``), results returned in
    request order.

    This is the engine scheduler's flush primitive: requests from different
    coroutines (different queries — with the shared rendezvous, on different
    workers; on the serving plane, from different tenants) sharing a group are
    stacked and dispatched together — the kernel wrappers are (B, N)-shaped,
    so one kernel launch serves every query in the batch.  ``refine`` requests
    carry vertex-id arrays (resident path, resolved against the request's —
    or the engine-default — registered table) or materialized (codes, lo,
    step) tuples (host-gather parity path); the two are never mixed within
    one system but may be mixed within one flush.

    ``hbm``/``splits`` thread the HBM record-cache tier through a flush:
    ``splits`` maps ``id(req)`` of an id-payload refine request to the
    (hit_mask, slot_indices) partition the engine resolved against the tier
    (``HbmTier.peek_split``).  Hit rows gather from cache slots
    (``refine_slots_many``, zero upload), miss rows take the ordinary
    registered-table path, and each request's results are merged back in id
    order.  With ``hbm=None`` (the default) the body below is untouched.
    """
    # the span's self time: grouping, query stacking, slicing results by owner
    sp = tracing.begin(_EXECUTE) if tracing.on else -1
    out: list = [None] * len(reqs)
    groups: dict[tuple, list[int]] = {}
    for i, r in enumerate(reqs):
        groups.setdefault(request_group_key(r, qb), []).append(i)
    for (kind, _), idxs in groups.items():
        gqb = reqs[idxs[0]].qb if reqs[idxs[0]].qb is not None else qb
        needs_qb = kind in ("estimate", "refine", "refine_rows") or (
            kind in ("beam", "beam_part") and reqs[idxs[0]].kind == "estimate"
        )
        if gqb is None and needs_qb:
            raise ValueError(
                "score requests of kind 'estimate'/'refine' need a "
                "QuantizedBase: set ScoreRequest.qb or pass qb= to the "
                "Engine / run_workload executing these coroutines"
            )
        if kind == "beam":
            res = engine.beam_step_many(gqb, [reqs[i] for i in idxs])
        elif kind == "beam_part":
            res = engine.beam_score_local_many(gqb, [reqs[i] for i in idxs])
        elif kind == "estimate":
            res = engine.estimate_many(
                gqb, [(reqs[i].pq, reqs[i].payload) for i in idxs]
            )
        elif kind == "refine":
            if splits and any(id(reqs[i]) in splits for i in idxs):
                res = _execute_refine_split(engine, gqb, hbm, reqs, idxs, splits)
            else:
                res = engine.refine_ids_many(
                    gqb, [(reqs[i].pq, reqs[i].payload) for i in idxs]
                )
        elif kind == "refine_rows":
            res = engine.refine_many(
                gqb, [(reqs[i].pq, *reqs[i].payload) for i in idxs]
            )
        elif kind == "full":
            res = engine.refine_full_many(
                [(reqs[i].query, reqs[i].payload) for i in idxs]
            )
        else:
            raise ValueError(f"unknown score request kind {kind!r}")
        for i, r_ in zip(idxs, res):
            out[i] = r_
    if sp >= 0:
        tracing.end(sp)
    return out


def _execute_refine_split(
    engine: DistanceEngine, gqb, hbm, reqs, idxs, splits
) -> list[np.ndarray]:
    """One refine dispatch group with HBM-tier residency splits: the miss
    rows of every request fuse into one registered-table gather, the hit
    rows into one slot gather, and each request's two result slices merge
    back in its original id order."""
    miss_groups: list[tuple] = []
    hit_groups: list[tuple] = []
    parts: list[tuple] = []  # (ids, mask | None) per request
    for i in idxs:
        r = reqs[i]
        ids = np.asarray(r.payload, dtype=np.int64)
        sp = splits.get(id(r))
        if sp is None:
            miss_groups.append((r.pq, ids))
            hit_groups.append((r.pq, np.empty(0, dtype=np.int64)))
            parts.append((ids, None))
        else:
            mask, slots = sp
            miss_groups.append((r.pq, ids[~mask]))
            hit_groups.append((r.pq, slots))
            parts.append((ids, mask))
    miss_res = engine.refine_ids_many(gqb, miss_groups)
    hit_res = engine.refine_slots_many(hbm, hit_groups)
    res: list[np.ndarray] = []
    for (ids, mask), mr, hr in zip(parts, miss_res, hit_res):
        if mask is None:
            res.append(mr)
            continue
        merged = np.empty(len(ids), dtype=np.float32)
        merged[~mask] = mr
        merged[mask] = hr
        res.append(merged)
    return res
