"""Device-resident beam state for the fused beam-step primitive.

With the distance GEMM on the device, a hop that downloads
raw per-row distances so the *host* can mask visited vertices, merge the
candidate heap, and pick the next frontier costs O(hops x kinds)
host<->device exchanges per query.  This module holds the per-query state and the pure
merge/selection helpers for the fused alternative: one ``("beam", ...)``
engine op per hop whose reply is the *frontier*, not distances.

The actual execution lives in ``repro_torch.core.distance`` (``beam_step_many``
and friends — scalar oracle / vectorized NumPy / one-call torch device
backends); everything here is plain NumPy so coroutines, the sharded merge
path, and the property tests can share one reference implementation.

Ordering contract (mirrors the host ``_Beam``): candidates rank by the
``(distance, vertex_id)`` tuple, ascending.  Internal padding lanes carry
``(+inf, PAD_VID)`` so they sort strictly after every real candidate —
"padding lanes never win" — and are stripped before results reach a
coroutine.  The visited/explored masks are boolean bitmasks over the vertex
id space with one spare slot at index ``n`` that device pad-lanes may write
harmlessly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Sorts after every real vertex id at equal distance, and fits int32 so a
# device path can keep candidate ids in 32-bit lanes.
PAD_VID = np.int64(2**31 - 1)
INF = np.float32(np.inf)


@dataclasses.dataclass
class BeamState:
    """Per-query search state that stays engine-resident across hops.

    ``cand_d``/``cand_v`` are the top-L candidate heap (sorted ascending by
    ``(d, v)``, padded with ``(INF, PAD_VID)``); ``visited``/``explored``
    are boolean masks over ``n + 1`` vertex ids (slot ``n`` is the pad
    sink).  On the torch backend the same fields hold device
    tensors; host backends keep NumPy.  ``backend`` records which, so the
    generic fallback paths know when to round-trip.
    """

    L: int
    n: int
    cand_d: np.ndarray
    cand_v: np.ndarray
    visited: np.ndarray
    explored: np.ndarray
    backend: str = "host"

    @classmethod
    def new(cls, L: int, n: int) -> "BeamState":
        return cls(
            L=int(L), n=int(n),
            cand_d=np.full(L, INF, dtype=np.float32),
            cand_v=np.full(L, PAD_VID, dtype=np.int64),
            visited=np.zeros(n + 1, dtype=bool),
            explored=np.zeros(n + 1, dtype=bool),
        )


@dataclasses.dataclass
class BeamRequest:
    """One fused beam step: score ``fresh`` (by id for the quantized level-1
    table, or by raw ``vectors`` for the fp32 in-memory path), drop already
    visited ids, fold in host-provided ``insert_ids``/``insert_ds`` (seed
    vertices, Starling's refined admissions), merge into the candidate heap,
    mark ``explored``, and select the next frontier.  ``rows``/``flop_s``
    feed the cost model exactly like ``ScoreRequest``.
    """

    kind: str                       # "estimate" (level-1 codes) | "full" (fp32)
    state: BeamState
    fresh: np.ndarray               # int64 vertex ids to score this hop
    explored: np.ndarray            # int64 ids to mark explored (pending marks)
    insert_ids: np.ndarray          # int64 ids inserted with known distances
    insert_ds: np.ndarray           # float32 distances for insert_ids
    rows: int
    flop_s: float
    pq: object = None               # QuantizedQuery for kind="estimate"
    query: np.ndarray | None = None  # fp32 query for kind="full"
    vectors: np.ndarray | None = None  # fp32 rows for kind="full"
    qb: object = None               # QuantizedBase (upload-charge accounting)
    tenant: int = 0
    topk: int = 0                   # >0: also read back the heap head
    vid_base: int = 0               # local->table id shift (serving plane)


@dataclasses.dataclass
class BeamResult:
    """Host-visible reply to one beam step — the ONE exchange per hop."""

    frontier: np.ndarray            # int64 unexplored window ids, (d, v) asc
    window_len: int                 # real (non-pad) candidates in the heap
    tail: float                     # heap slot L-1 distance (INF if underfull)
    topk_ids: np.ndarray | None = None
    topk_ds: np.ndarray | None = None


@dataclasses.dataclass
class BeamShardPart:
    """Per-shard slice of a multi-shard BeamRequest: score locally, return
    the local top-``L`` (ids, dists) for the engine's global merge — the
    ``dist_search`` mask-local-topk / merge-topk idiom, mask BEFORE any id
    translation.  ``state`` stays with the original request; parts carry
    only what the owning shard needs to score.
    """

    kind: str
    pq: object
    query: np.ndarray | None
    vectors: np.ndarray | None
    ids: np.ndarray                 # local vertex ids owned by this shard
    rows: int
    flop_s: float
    L: int
    qb: object = None
    tenant: int = 0
    vid_base: int = 0


# ---------------------------------------------------------------------------
# Pure helpers — the reference semantics shared by every backend.
# ---------------------------------------------------------------------------


def dedupe_first(ids: np.ndarray) -> np.ndarray:
    """Boolean keep-mask selecting the first occurrence of each id,
    preserving order — the host beam's first-wins insert semantics."""
    ids = np.asarray(ids)
    keep = np.zeros(ids.shape[0], dtype=bool)
    if ids.shape[0]:
        keep[np.unique(ids, return_index=True)[1]] = True
    return keep


def merge_topk(cand_d: np.ndarray, cand_v: np.ndarray,
               new_d: np.ndarray, new_v: np.ndarray,
               L: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge new (distance, id) pairs into a sorted top-``L`` heap.

    ``np.lexsort((v, d))`` == sort by the ``(d, v)`` tuple ascending — the
    exact order the host ``_Beam`` maintains via ``insort`` — and matches
    the two stable ``torch.sort`` passes of the torch path lane for lane.
    """
    d = np.concatenate([np.asarray(cand_d, np.float32),
                        np.asarray(new_d, np.float32)])
    v = np.concatenate([np.asarray(cand_v, np.int64),
                        np.asarray(new_v, np.int64)])
    order = np.lexsort((v, d))[:L]
    out_d = np.full(L, INF, dtype=np.float32)
    out_v = np.full(L, PAD_VID, dtype=np.int64)
    out_d[: order.shape[0]] = d[order]
    out_v[: order.shape[0]] = v[order]
    return out_d, out_v


def select_frontier(cand_d: np.ndarray, cand_v: np.ndarray,
                    explored: np.ndarray) -> tuple[np.ndarray, int, float]:
    """Frontier = unexplored heap entries in heap (ascending) order, plus the
    admission-window stats: real candidate count and the slot L-1 tail."""
    cand_v = np.asarray(cand_v, np.int64)
    cand_d = np.asarray(cand_d, np.float32)
    real = cand_v != PAD_VID
    live = real & ~explored[np.minimum(cand_v, explored.shape[0] - 1)]
    frontier = cand_v[live]
    return frontier, int(real.sum()), float(cand_d[-1])


def mask_ids(mask: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Test the boolean bitmask at ``ids`` (host backends)."""
    return mask[np.asarray(ids, np.int64)]


def set_ids(mask: np.ndarray, ids: np.ndarray) -> None:
    mask[np.asarray(ids, np.int64)] = True
