"""Continuous batching with cache-aware admission (paper C5 -> serving).

Each decode step assembles a batch of runnable requests.  When the KV pool is
oversubscribed (more requests than resident pages), the scheduler prioritizes
requests whose KV pages are RESIDENT — the serving analogue of Alg. 2's
in-memory pivot — so swap-ins happen off the busy path instead of stalling
every step.  Round-robin aging prevents starvation of swapped-out requests.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.serving.kv_pool import PagedKVPool


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt_len: int
    max_new_tokens: int
    generated: int = 0


class CacheAwareScheduler:
    def __init__(self, pool: PagedKVPool, max_batch: int = 8, age_boost: int = 4,
                 max_running: int | None = None):
        self.pool = pool
        self.max_batch = max_batch
        self.max_running = max_running or 2 * max_batch  # oversubscription: more
        # live requests than decode slots — the regime where cache-aware
        # ordering matters (the KV pool holds more requests than fit a batch)
        self.age_boost = age_boost     # steps after which a starved request
                                       # is scheduled regardless of residency
        self.queue: deque[ServeRequest] = deque()
        self.running: dict[int, ServeRequest] = {}
        self.starved: dict[int, int] = {}
        self.completed: list[int] = []

    def submit(self, req: ServeRequest) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and len(self.running) < self.max_running:
            req = self.queue.popleft()
            self.pool.add_request(req.rid)
            self.running[req.rid] = req
            self.starved[req.rid] = 0

    def next_batch(self) -> list[ServeRequest]:
        """Pick up to max_batch runnable requests, resident-first (C5)."""
        self._admit()
        ranked = sorted(
            self.running.values(),
            key=lambda r: (
                -(self.starved[r.rid] >= self.age_boost),      # aged first
                -self.pool.residency_fraction(r.rid),           # then resident
                r.rid,
            ),
        )
        batch = ranked[: self.max_batch]
        chosen = {r.rid for r in batch}
        for rid in self.running:
            self.starved[rid] = 0 if rid in chosen else self.starved[rid] + 1
        return batch

    def complete_step(self, batch: list[ServeRequest]) -> None:
        for req in batch:
            req.generated += 1
            if req.generated >= req.max_new_tokens:
                self.pool.finish_request(req.rid)
                del self.running[req.rid]
                del self.starved[req.rid]
                self.completed.append(req.rid)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running
