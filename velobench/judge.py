"""The comparison that decides ``correct``: the numbers a driver compares,
each against its limit from the cell's file.

- ``bad_answers``: answers that are not k distinct rows of the base in
  ascending order of finite distance, or that never came (exact: limit 0);
- ``dist_gap``: the widest relative gap between a distance the port returned
  and the reference's refined distance of the same row to the same query;
- ``est_gap``: the widest gap between a level-1 estimate the engine's search
  was given and the reference's estimate of the same row for the same
  query, over ``|q|^2 + |r|^2``, the size of the terms it is made of (an
  estimate near 0 is a difference of two such terms);
- ``id_mismatch``: the share of the port's returned rows that the
  reference's own answer to the query does not hold.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from velobench.reference import rabitq


def stack(answers: list, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids (m, k) int64, dists (m, k) float64) from per-answer (ids, dists)
    pairs; an answer that is None or short is padded with -1 and NaN."""
    ids = np.full((len(answers), k), -1, dtype=np.int64)
    ds = np.full((len(answers), k), np.nan, dtype=np.float64)
    for i, a in enumerate(answers):
        if a is None:
            continue
        a_ids, a_ds = np.asarray(a[0]).reshape(-1)[:k], np.asarray(a[1]).reshape(-1)[:k]
        m = min(len(a_ids), len(a_ds))
        ids[i, :m], ds[i, :m] = a_ids[:m], a_ds[:m]
    return ids, ds


def bad(ids: np.ndarray, dists: np.ndarray, n: int) -> np.ndarray:
    """(m,) bool: the answer is not k distinct in-range rows with finite,
    non-decreasing distances."""
    out = np.any((ids < 0) | (ids >= n), axis=1) | np.any(~np.isfinite(dists), axis=1)
    srt = np.sort(ids, axis=1)
    out |= np.any(srt[:, 1:] == srt[:, :-1], axis=1)
    with np.errstate(invalid="ignore"):
        out |= np.any(np.diff(dists, axis=1) < 0, axis=1)
    return out


def dist_gap(tables: rabitq.Tables, qr: torch.Tensor, ids: np.ndarray,
             dists: np.ndarray) -> np.ndarray:
    """(m,) the widest |returned - reference| / reference over each answer's
    rows; rows outside the table (bad answers) read as 0 here."""
    n = tables.codes.shape[0]
    dev = qr.device
    safe = torch.from_numpy(np.clip(ids, 0, n - 1)).to(dev)
    ref = rabitq.int4_dist2(tables, qr, safe).cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(dists - ref) / np.maximum(ref, 1e-12)
    gap[(ids < 0) | (ids >= n)] = 0.0
    gap = np.where(np.isfinite(gap), gap, 0.0)
    return gap.max(axis=1) if gap.shape[1] else np.zeros(len(gap))


def est_gap(got: np.ndarray, want: np.ndarray, scale: np.ndarray, answer: np.ndarray,
            m: int) -> np.ndarray:
    """(m,) the widest |got - want| / scale over the estimates of each of m
    answers (``answer`` names each estimate's); a missing or NaN estimate
    reads as infinite."""
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(got - want) / np.maximum(scale, 1e-12)
    gap = np.where(np.isnan(gap), np.inf, gap)
    out = np.zeros(m)
    np.maximum.at(out, answer, gap)
    return out


def id_mismatch(got: np.ndarray, want: np.ndarray) -> float:
    """The share of ``got``'s entries that the same row of ``want`` lacks."""
    if got.size == 0:
        return 0.0
    miss = sum(len(set(g.tolist()) - set(w.tolist())) for g, w in zip(got, want))
    return miss / got.size


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    """Recall@k of each answer against its exact top-k, averaged."""
    k = gt.shape[1]
    hits = sum(len(set(a[:k].tolist()) & set(g.tolist())) for a, g in zip(ids, gt))
    return hits / (len(gt) * k) if len(gt) else 0.0


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and none missing or NaN."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks
