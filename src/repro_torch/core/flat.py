"""Brute-force exact nearest neighbor search — the correctness oracle."""

from __future__ import annotations

import numpy as np


def pairwise_l2sq(base: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(q, n) matrix of squared L2 distances, computed blockwise."""
    # ||q - x||^2 = ||q||^2 - 2 q.x + ||x||^2
    bn = (base.astype(np.float32) ** 2).sum(axis=1)
    qn = (queries.astype(np.float32) ** 2).sum(axis=1)
    dots = queries.astype(np.float32) @ base.astype(np.float32).T
    return qn[:, None] - 2.0 * dots + bn[None, :]


def exact_topk(base: np.ndarray, queries: np.ndarray, k: int, block: int = 256) -> np.ndarray:
    """Exact top-k ids for each query (ties broken by id for determinism)."""
    n = base.shape[0]
    out = np.empty((queries.shape[0], k), dtype=np.int32)
    for s in range(0, queries.shape[0], block):
        q = queries[s : s + block]
        d2 = pairwise_l2sq(base, q)
        # stable top-k: argpartition then argsort by (dist, id)
        part = np.argpartition(d2, min(k, n - 1), axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.lexsort((part, pd), axis=1)
        out[s : s + block] = np.take_along_axis(part, order, axis=1)
    return out
