"""Vamana proximity-graph construction with fused affinity identification.

Implements DiskANN's Vamana build [23] with the paper's Algorithm 1 fused in:
while each vertex's greedy-search candidate set is in hand (already computed
for neighbor selection), filter it for affine vertices (d <= tau, up to k) at
"near-zero overhead" — no extra pass over the data, no O(n^2) reordering.

The build is *batched*: vertices are inserted in vectorized batches (greedy
searches run lockstep across the batch), which is also how ParlayANN-style
parallel builders work, and incidentally mirrors this repo's device-plane
batched search.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VamanaGraph:
    adjacency: np.ndarray      # (n, R) int32, -1 padded, sorted ascending per row
    degrees: np.ndarray        # (n,) int32
    medoid: int
    R: int
    # Alg. 1's S: p -> [(affine vid, d2), ...] nearest-first.  Distances are
    # retained so placement can re-filter for any tau' <= tau_collect without
    # rebuilding the graph (used by the Fig. 13 tau sweep).
    affinity: dict[int, list[tuple[int, float]]]
    tau: float

    def affinity_ids(self, tau_scale: float = 1.0, cap: int | None = None) -> dict[int, list[int]]:
        """Filter the stored affinity candidates down to d <= tau_scale * tau."""
        if tau_scale <= 0:
            return {}
        lim = (tau_scale * self.tau) ** 2
        out: dict[int, list[int]] = {}
        for p, cands in self.affinity.items():
            ids = [v for v, d2 in cands if d2 <= lim]
            if cap is not None:
                ids = ids[:cap]
            if ids:
                out[p] = ids
        return out

    @property
    def n(self) -> int:
        return self.adjacency.shape[0]

    def neighbors(self, v: int) -> np.ndarray:
        return self.adjacency[v, : self.degrees[v]]


# ------------------------------------------------------------------ utilities


def _dist2(base: np.ndarray, ids: np.ndarray, q: np.ndarray) -> np.ndarray:
    diff = base[ids] - q
    return np.einsum("ij,ij->i", diff, diff)


def find_medoid(base: np.ndarray, sample: int = 4096, seed: int = 0) -> int:
    rng = np.random.default_rng(seed)
    centroid = base.mean(axis=0)
    n = base.shape[0]
    ids = rng.choice(n, size=min(sample, n), replace=False)
    d2 = _dist2(base, ids, centroid)
    return int(ids[np.argmin(d2)])


def default_tau(base: np.ndarray, n_clusters: int = 32, iters: int = 8, seed: int = 0) -> float:
    """Paper §3.4: 'tau to the average of the 5th-percentile distance-to-centroid
    values across all clusters', clusters from the quantization stage.  We run a
    small k-means (the same clustering RaBitQ-style quantizers use)."""
    rng = np.random.default_rng(seed)
    n = base.shape[0]
    sample = base[rng.choice(n, size=min(n, 16_384), replace=False)]
    centers = sample[rng.choice(sample.shape[0], size=n_clusters, replace=False)].copy()
    for _ in range(iters):
        d2 = (
            (sample**2).sum(1)[:, None]
            - 2 * sample @ centers.T
            + (centers**2).sum(1)[None, :]
        )
        assign = d2.argmin(axis=1)
        for c in range(n_clusters):
            mask = assign == c
            if mask.any():
                centers[c] = sample[mask].mean(axis=0)
    d2 = (
        (sample**2).sum(1)[:, None]
        - 2 * sample @ centers.T
        + (centers**2).sum(1)[None, :]
    )
    assign = d2.argmin(axis=1)
    dmin = np.sqrt(np.maximum(d2[np.arange(len(sample)), assign], 0.0))
    percs = []
    for c in range(n_clusters):
        mask = assign == c
        if mask.sum() >= 5:
            percs.append(np.percentile(dmin[mask], 5.0))
    tau_centroid = float(np.mean(percs)) if percs else float(np.percentile(dmin, 5.0))

    # Adaptation: the paper's centroid-percentile heuristic can fall below the
    # typical nearest-neighbor distance (then no pair is ever 'affine' and
    # co-placement silently degenerates).  Floor tau at the median 2nd-NN
    # distance of a small sample so affinity groups are non-trivial on any
    # geometry.
    sub = sample[rng.choice(sample.shape[0], size=min(1024, sample.shape[0]), replace=False)]
    dd = (
        (sub**2).sum(1)[:, None] - 2 * sub @ sub.T + (sub**2).sum(1)[None, :]
    )
    np.fill_diagonal(dd, np.inf)
    nn2 = np.sqrt(np.maximum(np.partition(dd, 1, axis=1)[:, 1], 0.0))
    tau_nn = float(np.median(nn2)) * 1.1
    return max(tau_centroid, tau_nn)


# ---------------------------------------------------------- batched greedy search


def batched_greedy_search(
    base: np.ndarray,
    adjacency: list[np.ndarray],
    entry: int,
    queries: np.ndarray,
    L: int,
    max_iters: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Lockstep greedy search for a batch of queries over the *current* graph.

    Returns (visited_ids, visited_d2): (B, T) arrays padded with -1/inf, in
    visit order — exactly the [V, D] of Alg. 1 line 5 that both RobustPrune and
    affinity extraction consume.
    """
    B = queries.shape[0]
    max_iters = max_iters or (4 * L)

    INF = np.float32(np.inf)
    cand_ids = np.full((B, L), -1, dtype=np.int64)
    cand_d2 = np.full((B, L), INF, dtype=np.float32)
    cand_visited = np.ones((B, L), dtype=bool)  # padding counts as visited

    diff = base[entry][None, :] - queries
    cand_ids[:, 0] = entry
    cand_d2[:, 0] = np.einsum("ij,ij->i", diff, diff)
    cand_visited[:, 0] = False

    visited_ids: list[np.ndarray] = []
    visited_d2: list[np.ndarray] = []

    for _ in range(max_iters):
        masked = np.where(cand_visited, INF, cand_d2)
        best = masked.argmin(axis=1)
        active = ~np.take_along_axis(cand_visited, best[:, None], axis=1)[:, 0]
        if not active.any():
            break
        cur = np.take_along_axis(cand_ids, best[:, None], axis=1)[:, 0]
        cur_d2 = np.take_along_axis(cand_d2, best[:, None], axis=1)[:, 0]
        np.put_along_axis(cand_visited, best[:, None], True, axis=1)

        visited_ids.append(np.where(active, cur, -1))
        visited_d2.append(np.where(active, cur_d2, INF))

        # gather neighbors of each current vertex (ragged -> padded)
        neigh_list = [adjacency[int(c)] if a else np.empty(0, np.int32) for c, a in zip(cur, active)]
        width = max((len(x) for x in neigh_list), default=0)
        if width == 0:
            continue
        neigh = np.full((B, width), -1, dtype=np.int64)
        for i, nl in enumerate(neigh_list):
            neigh[i, : len(nl)] = nl
        valid = neigh >= 0
        flat = np.where(valid, neigh, 0)
        diffs = base[flat.reshape(-1)].reshape(B, width, -1) - queries[:, None, :]
        nd2 = np.einsum("bwd,bwd->bw", diffs, diffs).astype(np.float32)
        nd2 = np.where(valid, nd2, INF)

        # merge: concat then (dedupe-by-id) then keep top-L by distance
        all_ids = np.concatenate([cand_ids, neigh], axis=1)
        all_d2 = np.concatenate([cand_d2, nd2], axis=1)
        all_vis = np.concatenate([cand_visited, ~valid], axis=1)

        # dedupe: sort by id, mark repeats as inf
        order = np.argsort(all_ids, axis=1, kind="stable")
        sid = np.take_along_axis(all_ids, order, axis=1)
        sd2 = np.take_along_axis(all_d2, order, axis=1)
        svis = np.take_along_axis(all_vis, order, axis=1)
        dup = np.zeros_like(sid, dtype=bool)
        dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
        # a duplicate inherits visited-ness from its first copy (cummax over runs)
        first_vis = svis & ~dup
        # propagate visitedness forward across duplicate runs
        run_vis = np.logical_or.accumulate(
            np.where(dup, False, svis), axis=1
        )  # not exact per-run; handled below via id-keyed visited set instead
        sd2 = np.where(dup, INF, sd2)

        # keep top-L by distance
        order2 = np.argsort(sd2, axis=1, kind="stable")[:, :L]
        cand_ids = np.take_along_axis(sid, order2, axis=1)
        cand_d2 = np.take_along_axis(sd2, order2, axis=1)
        cand_visited = np.take_along_axis(svis, order2, axis=1)
        cand_visited |= cand_d2 == INF
        del run_vis, first_vis

        # mark any candidate equal to an already-visited vertex as visited
        # (duplicates across iterations): check against visit history
        if visited_ids:
            hist = np.stack(visited_ids, axis=1)  # (B, t)
            eq = cand_ids[:, :, None] == hist[:, None, :]
            cand_visited |= eq.any(axis=2)

    T = len(visited_ids)
    if T == 0:
        return np.full((B, 1), -1, np.int64), np.full((B, 1), np.inf, np.float32)
    return np.stack(visited_ids, axis=1), np.stack(visited_d2, axis=1)


# ----------------------------------------------------------------- robust prune


def robust_prune(
    p: int,
    cand_ids: np.ndarray,
    cand_d2: np.ndarray,
    base: np.ndarray,
    R: int,
    alpha: float,
) -> np.ndarray:
    """DiskANN RobustPrune: alpha-dominated candidate elimination.

    alpha * d(p*, v) <= d(p, v)  (metric)  <=>  alpha^2 * d2(p*, v) <= d2(p, v).
    """
    mask = cand_ids >= 0
    ids = cand_ids[mask].astype(np.int64)
    d2 = cand_d2[mask].astype(np.float32)
    ids, uniq = np.unique(ids, return_index=True)
    d2 = d2[uniq]
    keep = ids != p
    ids, d2 = ids[keep], d2[keep]
    order = np.argsort(d2, kind="stable")
    ids, d2 = ids[order], d2[order]

    out: list[int] = []
    alive = np.ones(len(ids), dtype=bool)
    a2 = np.float32(alpha * alpha)
    while alive.any() and len(out) < R:
        i = int(np.argmax(alive))  # first alive = nearest remaining
        p_star = int(ids[i])
        out.append(p_star)
        alive[i] = False
        rem = np.nonzero(alive)[0]
        if len(rem) == 0:
            break
        dd = base[ids[rem]] - base[p_star]
        d2_star = np.einsum("ij,ij->i", dd, dd)
        dominated = a2 * d2_star <= d2[rem]
        alive[rem[dominated]] = False
    return np.asarray(sorted(out), dtype=np.int32)


# ------------------------------------------------------------------- the build


def build_vamana(
    base: np.ndarray,
    R: int = 32,
    L: int = 64,
    alpha: float = 1.2,
    tau: float | None = None,
    affine_k: int = 8,
    batch_size: int = 256,
    seed: int = 0,
    two_pass: bool = True,
) -> VamanaGraph:
    """Algorithm 1: Vamana build + fused affine-record identification."""
    n, d = base.shape
    rng = np.random.default_rng(seed)
    if tau is None:
        tau = default_tau(base, seed=seed)
    # collect affinity candidates out to 2*tau so placement can sweep tau
    tau2_collect = np.float32((2.0 * tau) ** 2)

    # random R-regular initial graph
    adjacency: list[np.ndarray] = []
    for v in range(n):
        nb = rng.choice(n, size=min(R, n - 1), replace=False)
        nb = nb[nb != v][: R]
        adjacency.append(np.asarray(sorted(set(int(x) for x in nb)), dtype=np.int32))

    medoid = find_medoid(base, seed=seed)
    affinity: dict[int, list[tuple[int, float]]] = {}

    passes = [1.0, alpha] if two_pass else [alpha]
    for pass_idx, pass_alpha in enumerate(passes):
        order = rng.permutation(n)
        final_pass = pass_idx == len(passes) - 1
        for s in range(0, n, batch_size):
            batch = order[s : s + batch_size]
            V, D = batched_greedy_search(base, adjacency, medoid, base[batch], L)

            inbox: dict[int, list[int]] = {}
            for bi, p in enumerate(batch):
                p = int(p)
                vids, vd2 = V[bi], D[bi]
                ok = vids >= 0

                # ---- Alg. 1 lines 6-10: affinity extraction (final pass only,
                # so colors reflect the final geometry; same reuse argument)
                if final_pass:
                    aff_mask = ok & (vd2 <= tau2_collect) & (vids != p)
                    aff_ids = vids[aff_mask]
                    aff_d2 = vd2[aff_mask]
                    if len(aff_ids):
                        sel = np.argsort(aff_d2, kind="stable")[:affine_k]
                        affinity[p] = [
                            (int(i), float(dd)) for i, dd in zip(aff_ids[sel], aff_d2[sel])
                        ]

                # ---- Alg. 1 line 12: prune to out-neighbors
                cand_ids = np.concatenate([vids[ok], adjacency[p]])
                dd = base[cand_ids.astype(np.int64)] - base[p]
                cand_d2 = np.einsum("ij,ij->i", dd, dd).astype(np.float32)
                new_out = robust_prune(p, cand_ids, cand_d2, base, R, pass_alpha)
                adjacency[p] = new_out

                # ---- Alg. 1 lines 13-16: reverse edges (deferred to batch end)
                for v in new_out:
                    inbox.setdefault(int(v), []).append(p)

            for v, incoming in inbox.items():
                merged = np.unique(
                    np.concatenate([adjacency[v], np.asarray(incoming, np.int32)])
                )
                merged = merged[merged != v]
                if len(merged) > R:
                    dd = base[merged.astype(np.int64)] - base[v]
                    d2v = np.einsum("ij,ij->i", dd, dd).astype(np.float32)
                    adjacency[v] = robust_prune(v, merged, d2v, base, R, pass_alpha)
                else:
                    adjacency[v] = merged.astype(np.int32)

    adj = np.full((n, R), -1, dtype=np.int32)
    deg = np.zeros(n, dtype=np.int32)
    for v in range(n):
        a = adjacency[v][:R]
        adj[v, : len(a)] = a
        deg[v] = len(a)
    return VamanaGraph(
        adjacency=adj, degrees=deg, medoid=medoid, R=R, affinity=affinity, tau=tau
    )
