"""The benchmark's inputs: a frozen copy of the port's dataset generator.

``generate`` draws exactly what ``repro_torch.core.dataset.make_dataset``
draws, in the same order from the same ``numpy`` generator: a clustered
Gaussian base set (``n / 40`` clusters by default, noise 0.3, centres at
spread ``2 / sqrt(d)``) and a query pool drawn near the centres with Zipf
skew ``query_skew`` over clusters.  It stops there: the ground truth is the
reference's (``reference/exact.py``), worked out on the card after the
window.  The copy is frozen so that a change to the port cannot change the
benchmark's data.

Everything is made from a run's ``--seed``: the base vectors, the pool of
queries (the stream a run serves, in the pool's order) and, in the drivers,
the port's own build seeds, as ``launch/serve.py`` passes its ``--seed`` to
each.  A configuration's sizes and a traffic's skew are the same for every
seed; only the draw differs.

A configuration that names a ``data_seed`` is one index that every run
serves: its base, its pool and the drivers' build seeds come from
``data_seed``, and the run's ``--seed`` draws the order in which the pool is
served, so that every seed sends the same set of queries in another order.
"""

from __future__ import annotations

import numpy as np


def generate(n: int, d: int, pool: int, seed: int, query_skew: float = 1.2,
             noise: float = 0.3, n_clusters: int | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
    """(base (n, d) float32, queries (pool, d) float32) from ``seed``."""
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(32, n // 40)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers *= 2.0 / np.sqrt(d)

    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + noise * rng.standard_normal((n, d)).astype(np.float32)
    base = base.astype(np.float32)

    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    probs = ranks ** (-query_skew)
    probs /= probs.sum()
    q_assign = rng.choice(n_clusters, size=pool, p=probs)
    queries = centers[q_assign] + noise * rng.standard_normal((pool, d)).astype(np.float32)
    return base, queries.astype(np.float32)


def index_seed(cfg: dict, seed: int) -> int:
    """The seed of a configuration's data and builds: its ``data_seed``
    where it names one, else the run's."""
    return int(cfg.get("data_seed", seed))


def inputs(cfg: dict, traffic: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A configuration's base vectors and a traffic's query pool, from
    ``seed``; where the configuration names a ``data_seed``, from that, with
    the pool in an order drawn from ``seed``."""
    base, pool = generate(cfg["n"], cfg["d"], traffic["pool"], index_seed(cfg, seed),
                          query_skew=traffic["query_skew"], noise=cfg["noise"])
    if "data_seed" in cfg:
        pool = pool[np.random.default_rng(seed).permutation(len(pool))]
    return base, pool
