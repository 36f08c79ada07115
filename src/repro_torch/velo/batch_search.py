"""Batched lockstep cache-aware beam search — the coroutine model on a card.

The paper runs B query coroutines per core and switches on I/O.  Here the
B-way concurrency is a B-row *vectorized* beam search advanced in lockstep
(the reference's ``lax.scan`` becomes a Python loop of ``max_steps`` steps
whose tensors stay on the device: no copy to the host inside the loop):

  * one step = every query expands its best unvisited candidate;
  * neighbor gathers for the whole batch coalesce into one device gather —
    the io_uring batched-submission analogue;
  * level-1 (binary) estimates steer the beam; level-2 (int4) refinement is
    applied once at the end to the surviving beam (one batched rerank
    instead of per-step scalar refinement).

``_estimate`` and ``_refine`` are plain tensor ops, as in the reference
(which writes them in jnp, not Pallas), with the same casts and order of
operations.  Every sort is stable and every argmin takes the first of equal
values, so ties resolve as the reference's ``jnp.argsort`` / ``jnp.argmin``
resolve them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.velo.index import DeviceIndex

INF = 3e38  # float32, as the reference's jnp.float32(3e38)


def _prepare_queries(index: DeviceIndex, q: torch.Tensor):
    """(qr, qnorm, qunit, qc): the rotated residuals ``(q - c) R^T`` (B, dim),
    their norms (B, 1) and unit vectors, and for an inner-product index each
    query's ``<q, c>`` (B, 1) (None for squared L2).  Queries of
    ``index.in_dim`` are padded with zeros to ``index.dim`` first."""
    if q.shape[1] != index.in_dim:
        raise ValueError(f"queries of width {q.shape[1]} for an index of width {index.in_dim}")
    if index.in_dim != index.dim:
        q = torch.nn.functional.pad(q, (0, index.dim - index.in_dim))
    qr = (q - index.centroid[None, :]) @ index.rotation.T
    qnorm = torch.linalg.vector_norm(qr, dim=1, keepdim=True)
    qunit = qr / torch.clamp_min(qnorm, 1e-12)
    qc = (q @ index.centroid)[:, None] if index.metric == "ip" else None
    return qr, qnorm, qunit, qc


def _estimate(index: DeviceIndex, ids: torch.Tensor, qunit: torch.Tensor, qnorm: torch.Tensor):
    """Level-1 estimates for gathered ids: ids (B, M), qunit (B, d) -> (B, M)."""
    d = index.dim
    codes = index.binary_codes[ids]                      # (B, M, d/8)
    c = codes.to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=c.device)
    bits = (c[..., None] >> shifts) & 1                  # (B, M, d/8, 8)
    signs = (2 * bits - 1).reshape(*ids.shape, d).to(torch.float32)
    g = torch.einsum("bmd,bd->bm", signs, qunit) / math.sqrt(d)
    ipb = torch.clamp_min(index.ip_bar[ids], 1e-6)
    est_cos = torch.clamp(g / ipb, -1.0, 1.0)
    nr = index.norms[ids]
    return qnorm**2 + nr**2 - 2.0 * qnorm * nr * est_cos


def _refine(index: DeviceIndex, ids: torch.Tensor, qr: torch.Tensor,
            qc: torch.Tensor | None = None):
    """Level-2 int4 refinement for gathered ids: (B, M) -> (B, M) dist^2, or
    for an inner-product index (``qc`` the queries' ``<q, c>``, (B, 1)) the
    negated inner product ``-((<q, c> + <qr, x>) + cr)``, so that the best
    rows come first in ascending order under both metrics."""
    d = index.dim
    packed = index.ext_codes[ids].to(torch.int32)        # (B, M, d/2)
    lo4 = (packed & 0xF).to(torch.float32)
    hi4 = ((packed >> 4) & 0xF).to(torch.float32)
    codes = torch.stack([lo4, hi4], dim=-1).reshape(*ids.shape, d)
    x = codes * index.ext_step[ids][..., None] + index.ext_lo[ids][..., None]
    if index.metric == "ip":
        return -((qc + torch.einsum("bmd,bd->bm", x, qr)) + index.cr[ids])
    diff = qr[:, None, :] - x
    return torch.einsum("bmd,bmd->bm", diff, diff)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def _merge_and_trim(ids, dist, visited, new_ids, new_dist, L, sentinel):
    """Concat beams with expansions, dedupe by id, keep top-L by distance."""
    all_ids = torch.cat([ids, new_ids], dim=1)
    all_dist = torch.cat([dist, new_dist], dim=1)
    all_vis = torch.cat([visited, torch.zeros_like(new_ids, dtype=torch.bool)], dim=1)

    # dedupe: sort by id (stably); runs of equal REAL ids have length <= 2
    # here (beam rows are unique post-trim, adjacency rows are unique), so one
    # neighbor-pair aggregation suffices: the first copy takes min(dist) and
    # OR(visited), the second copy is killed.
    order = torch.argsort(all_ids, dim=1, stable=True)
    sid = _take(all_ids, order)
    sdist = _take(all_dist, order)
    svis = _take(all_vis, order)
    eq = sid[:, 1:] == sid[:, :-1]
    zeros = torch.zeros_like(sid[:, :1], dtype=torch.bool)
    nxt_same = torch.cat([eq, zeros], dim=1)   # next element is my dup
    prv_same = torch.cat([zeros, eq], dim=1)   # I am the dup copy
    sdist_nxt = torch.roll(sdist, -1, dims=1)
    svis_nxt = torch.roll(svis, -1, dims=1)
    sdist = torch.where(nxt_same, torch.minimum(sdist, sdist_nxt), sdist)
    svis = torch.where(nxt_same, svis | svis_nxt, svis)
    # a killed copy must ALSO forfeit its id: on an underfull beam the
    # (INF, visited) tail survives the trim, and a ghost that kept a real id
    # would pair with that id's live copy in a LATER merge — the OR(visited)
    # aggregation would then falsely mark the live candidate visited (and a
    # 3-long run would break the pairwise-dedupe assumption above)
    sid = torch.where(prv_same, sentinel, sid)
    sdist = torch.where(prv_same, INF, sdist)
    svis = torch.where(prv_same, True, svis)

    order2 = torch.argsort(sdist, dim=1, stable=True)[:, :L]
    ids = _take(sid, order2)
    dist = _take(sdist, order2)
    visited = _take(svis, order2)
    visited = visited | (dist >= INF)
    return ids, dist, visited


def batch_search(
    index: DeviceIndex,
    queries: torch.Tensor,   # (B, d)
    L: int = 64,
    k: int = 10,
    max_steps: int = 96,
):
    """Returns (ids (B, k) int64, dist2 (B, k) f32, steps_executed (B,)
    int32), on the index's device."""
    dev = index.device
    queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    if index.metric != "l2":
        raise ValueError("batch_search serves squared L2; scan_search serves inner product")
    B, d = queries.shape
    qr, qnorm, qunit, _ = _prepare_queries(index, queries)
    n = index.n
    rows = torch.arange(B, device=dev)

    ids = torch.full((B, L), n, dtype=torch.int64, device=dev)   # sentinel-filled
    dist = torch.full((B, L), INF, dtype=torch.float32, device=dev)
    visited = torch.ones((B, L), dtype=torch.bool, device=dev)

    medoid = index.medoid.expand(B, 1)
    med_est = _estimate(index, medoid, qunit, qnorm)
    ids[:, 0] = medoid[:, 0]
    dist[:, 0] = med_est[:, 0]
    visited[:, 0] = False

    # global seen-set: one bit per vertex per query (the lockstep analogue of
    # the host's per-coroutine `seen`); sentinel row pre-marked.  Neighbour
    # ids repeat across rows, so it is set by index_put_, never accumulated.
    seen = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    seen[:, -1] = True
    seen[rows, medoid[:, 0]] = True
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)

    for _ in range(max_steps):
        masked = torch.where(visited, INF, dist)
        bi = torch.argmin(masked, dim=1)                   # (B,) first of equals
        best = _take(masked, bi[:, None])[:, 0]
        active = best < INF
        cur = _take(ids, bi[:, None])[:, 0]
        cur = torch.where(active, cur, n)
        visited = torch.where(
            active[:, None], visited.scatter(1, bi[:, None], True), visited)

        neigh = index.adjacency[cur]                       # (B, R)
        fresh = ~_take(seen, neigh)                        # (B, R)
        est = _estimate(index, neigh, qunit, qnorm)
        est = torch.where(fresh & active[:, None], est, INF)
        seen.index_put_((rows[:, None], neigh), true)

        ids, dist, visited = _merge_and_trim(ids, dist, visited, neigh, est, L, n)
        steps += active.to(torch.int32)

    # final rerank: int4 refinement of the surviving beam, take top-k
    refined = _refine(index, ids, qr)
    refined = torch.where(dist >= INF, INF, refined)
    order = torch.argsort(refined, dim=1, stable=True)[:, :k]
    return _take(ids, order), _take(refined, order), steps
