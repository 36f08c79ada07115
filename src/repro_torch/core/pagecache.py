"""Page-level caches with classic replacement policies (paper Table 1 baselines).

These are what DiskANN-style systems use; the paper shows they track the
buffer ratio almost linearly because ANN page access has no locality for them
to exploit.  Policies: LRU, FIFO, Random (Table 1), plus CLOCK for parity
with the record pool.
"""

from __future__ import annotations

from collections import OrderedDict, deque

import numpy as np


class PageCache:
    def __init__(self, capacity_pages: int, policy: str = "lru", seed: int = 0):
        assert capacity_pages >= 1
        assert policy in ("lru", "fifo", "random", "clock")
        self.capacity = capacity_pages
        self.policy = policy
        self.rng = np.random.default_rng(seed)
        self.pages: OrderedDict[int, bytes] = OrderedDict()
        self.fifo: deque[int] = deque()
        # clock state
        self.ref_bit: dict[int, bool] = {}
        self.clock_ring: list[int] = []
        self.hand = 0
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, pid: int) -> bytes | None:
        page = self.pages.get(pid)
        if page is not None:
            self.hits += 1
            if self.policy == "lru":
                self.pages.move_to_end(pid)
            elif self.policy == "clock":
                self.ref_bit[pid] = True
            return page
        self.misses += 1
        return None

    def contains(self, pid: int) -> bool:
        return pid in self.pages

    def admit(self, pid: int, page: bytes) -> None:
        if pid in self.pages:
            return
        while len(self.pages) >= self.capacity:
            self._evict_one()
        self.pages[pid] = page
        if self.policy == "fifo":
            self.fifo.append(pid)
        elif self.policy == "clock":
            self.ref_bit[pid] = False
            self.clock_ring.append(pid)

    def _evict_one(self) -> None:
        self.evictions += 1
        if self.policy == "lru":
            self.pages.popitem(last=False)
        elif self.policy == "fifo":
            while True:
                pid = self.fifo.popleft()
                if pid in self.pages:
                    del self.pages[pid]
                    return
        elif self.policy == "random":
            keys = list(self.pages.keys())
            pid = keys[int(self.rng.integers(0, len(keys)))]
            del self.pages[pid]
        elif self.policy == "clock":
            while True:
                if not self.clock_ring:
                    # fall back: evict arbitrary
                    pid, _ = self.pages.popitem(last=False)
                    self.ref_bit.pop(pid, None)
                    return
                self.hand %= len(self.clock_ring)
                pid = self.clock_ring[self.hand]
                if pid not in self.pages:
                    self.clock_ring.pop(self.hand)
                    self.ref_bit.pop(pid, None)
                    continue
                if self.ref_bit.get(pid, False):
                    self.ref_bit[pid] = False
                    self.hand += 1
                else:
                    self.clock_ring.pop(self.hand)
                    self.ref_bit.pop(pid, None)
                    del self.pages[pid]
                    return

    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0
