"""Synthetic LM data pipeline: deterministic, sharded, host-prefetched.

Streams (tokens, labels) batches from a seeded synthetic distribution with
learnable structure (a noisy affine next-token rule over the vocab), so a
real training run shows a falling loss (examples/train_lm_torch.py).  Sharding is
by (host_id, step): every host generates only its slice, and any step can be
regenerated exactly — which is what makes checkpoint/restart and elastic
resharding deterministic (fault-tolerance tests rely on this).

A NumPy copy of the JAX package's pipeline: the same (seed, step, host)
gives the same arrays in both packages.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    noise: float = 0.15       # fraction of uniform-random tokens
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _gen_batch(cfg: DataConfig, step: int) -> dict:
    """The (host, step)-deterministic batch."""
    assert cfg.global_batch % cfg.n_hosts == 0
    local = cfg.global_batch // cfg.n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )
    V = cfg.vocab_size
    start = rng.integers(0, V, size=(local, 1))
    # affine walk: x_{t+1} = (a*x_t + b) % V with per-sequence (a, b)
    a = rng.integers(1, 8, size=(local, 1))
    b = rng.integers(0, V, size=(local, 1))
    toks = np.empty((local, cfg.seq_len + 1), dtype=np.int64)
    toks[:, 0:1] = start
    for t in range(cfg.seq_len):
        toks[:, t + 1] = (a[:, 0] * toks[:, t] + b[:, 0]) % V
    noise_mask = rng.random((local, cfg.seq_len + 1)) < cfg.noise
    noise_vals = rng.integers(0, V, size=(local, cfg.seq_len + 1))
    toks = np.where(noise_mask, noise_vals, toks)
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


class DataLoader:
    """Background-thread prefetcher with a straggler deadline.

    next_batch(timeout) raises StragglerTimeout if the pipeline can't deliver
    in time — launch/elastic.py's straggler mitigation skips to a freshly
    generated batch id instead of stalling the step (data-echo style skip)."""

    def __init__(self, cfg: DataConfig, prefetch: int = 4, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch = _gen_batch(self.cfg, step)
            batch["_step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next_batch(self, timeout: float | None = None) -> dict:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise StragglerTimeout(f"data stall > {timeout}s")

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


class StragglerTimeout(TimeoutError):
    pass


def batch_for_step(cfg: DataConfig, step: int) -> dict:
    """Direct (non-threaded) deterministic access — restart/replay path."""
    return _gen_batch(cfg, step)
