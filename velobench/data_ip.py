"""The inner-product deployment's inputs: a frozen generator of base vectors
whose norms vary and of queries from another distribution than the base.

It imports nothing of the port, and is frozen so that a change to the port
cannot change the benchmark's data.  From one ``numpy`` generator, in this
order:

- the base, clustered Gaussian as ``data.py`` draws it (``n / 40`` clusters,
  centres at spread ``2 / sqrt(d)``, noise ``noise`` a coordinate), then
  each row scaled by its own lognormal factor ``exp(norm_spread * N(0, 1))``,
  so that rows of one direction differ in norm and inner product is not L2
  or cosine in disguise (the image embeddings of text2image-1B are not
  normalised);
- the queries: near the base's cluster centres, the clusters drawn with
  Zipf skew ``query_skew``, then moved by one fixed offset, a seeded
  direction of norm ``query_shift * noise * sqrt(d)`` (the base's spread of
  a row about its centre), plus noise ``noise`` a coordinate: out of the
  base's distribution as text queries are out of the image embeddings'.

A configuration names a ``data_seed``: its base and its pool come from that,
and a run's ``--seed`` draws the order in which the pool is served, so that
every seed sends the same set of queries over the same rows.
"""

from __future__ import annotations

import numpy as np


def generate(n: int, d: int, pool: int, seed: int, query_skew: float, noise: float,
             norm_spread: float, query_shift: float) -> tuple[np.ndarray, np.ndarray]:
    """(base (n, d) float32, queries (pool, d) float32) from ``seed``."""
    rng = np.random.default_rng(seed)
    n_clusters = max(32, n // 40)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers *= 2.0 / np.sqrt(d)

    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + noise * rng.standard_normal((n, d)).astype(np.float32)
    base *= np.exp(norm_spread * rng.standard_normal(n)).astype(np.float32)[:, None]

    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    probs = ranks ** (-query_skew)
    probs /= probs.sum()
    q_assign = rng.choice(n_clusters, size=pool, p=probs)
    shift = rng.standard_normal(d)
    shift *= query_shift * noise * np.sqrt(d) / np.linalg.norm(shift)
    queries = (centers[q_assign] + shift.astype(np.float32)
               + noise * rng.standard_normal((pool, d)).astype(np.float32))
    return base.astype(np.float32), queries.astype(np.float32)


def inputs(cfg: dict, traffic: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A configuration's base vectors and a traffic's query pool from the
    configuration's ``data_seed``, the pool in an order drawn from ``seed``."""
    base, pool = generate(cfg["n"], cfg["d"], traffic["pool"], int(cfg["data_seed"]),
                          traffic["query_skew"], cfg["noise"], cfg["norm_spread"],
                          cfg["query_shift"])
    return base, pool[np.random.default_rng(seed).permutation(len(pool))]
