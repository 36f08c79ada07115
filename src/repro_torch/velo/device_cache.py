"""HBM record cache with record-map indirection + vectorized clock (§3.2 on device).

For corpora larger than device memory the ext codes + adjacency live on the
host ("SSD" tier); HBM holds a fixed-slot cache of decoded records.  This
module keeps the paper's exact structures as device arrays:

  record_map (n,) int32 — hybrid pointer: >= 0 slot index (resident),
                          < 0 encodes the host page id as -(pid+1)
  slot_state (S,) int8  — FREE/LOCKED/OCCUPIED/MARKED (Fig. 5)
  slot_vid   (S,) int32
  cache_ext  (S, d/2) uint8 / cache_lo/step (S,) / cache_adj (S, R) int32

The clock sweep is a *vectorized* pass: instead of
an atomically-advancing hand, one pass demotes OCCUPIED->MARKED and selects
the first `need` MARKED slots past the hand for eviction — identical steady
state, race-free by lockstep construction.

The engine loop (host-driven):
  1. run a search step on device; collect the miss list (ids not resident)
  2. fetch missing records' affinity groups from the host store
  3. scatter them into cache slots (this is the DMA the paper overlaps);
     prefetch for step t+1 issues while step t computes (double buffering)
"""

from __future__ import annotations

import dataclasses

import numpy as np


FREE, LOCKED, OCCUPIED, MARKED = 0, 1, 2, 3


@dataclasses.dataclass
class DeviceRecordCache:
    """Functional cache state; numpy-backed (the host mirror of the device
    arrays — updates produce the scatter indices/values a device step applies)."""

    record_map: np.ndarray     # (n,) int32
    disk_pages: np.ndarray     # (n,) int32 — immutable page ids (host tier)
    slot_state: np.ndarray     # (S,) int8
    slot_vid: np.ndarray       # (S,) int32
    cache_ext: np.ndarray      # (S, d/2) uint8
    cache_lo: np.ndarray       # (S,)
    cache_step: np.ndarray     # (S,)
    cache_adj: np.ndarray      # (S, R) int32
    hand: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @classmethod
    def create(cls, n_slots: int, vid_to_page: np.ndarray, dim: int, R: int,
               code_cols: int | None = None):
        n = len(vid_to_page)
        if code_cols is None:
            code_cols = dim // 2  # 4-bit packed ext codes (8-bit passes dim)
        return cls(
            record_map=-(vid_to_page.astype(np.int32) + 1),
            disk_pages=vid_to_page.astype(np.int32),
            slot_state=np.full(n_slots, FREE, np.int8),
            slot_vid=np.full(n_slots, -1, np.int32),
            cache_ext=np.zeros((n_slots, code_cols), np.uint8),
            cache_lo=np.zeros(n_slots, np.float32),
            cache_step=np.ones(n_slots, np.float32),
            cache_adj=np.full((n_slots, R), -1, np.int32),
        )

    @property
    def n_slots(self) -> int:
        return len(self.slot_state)

    # ------------------------------------------------------------- residency

    def resident_mask(self, vids: np.ndarray) -> np.ndarray:
        return self.record_map[vids] >= 0

    def touch(self, vids: np.ndarray) -> None:
        """Vectorized lookup side effects: hits give MARKED slots a second chance."""
        res = self.resident_mask(vids)
        slots = self.record_map[vids[res]]
        marked = self.slot_state[slots] == MARKED
        self.slot_state[slots[marked]] = OCCUPIED
        self.hits += int(res.sum())
        self.misses += int((~res).sum())

    # ----------------------------------------------------------------- clock

    def sweep(self, need: int) -> np.ndarray:
        """Vectorized clock: returns freed slot indices (len <= need; LOCKED
        slots are never reclaimed, and `need` is capped at the slot count)."""
        need = min(need, self.n_slots)
        freed: list[int] = []
        for _ in range(3):  # at most 3 passes (mirror of the host-plane bound)
            if len(freed) >= need:
                break
            order = (np.arange(self.n_slots) + self.hand) % self.n_slots
            states = self.slot_state[order]
            # first demote-or-evict pass in hand order
            for idx, st in zip(order, states):
                if len(freed) >= need:
                    break
                if st == OCCUPIED:
                    self.slot_state[idx] = MARKED
                elif st == MARKED:
                    vid = int(self.slot_vid[idx])
                    self.record_map[vid] = -(int(self.disk_pages[vid]) + 1)
                    self._evict(idx)
                    freed.append(idx)
                self.hand = (int(idx) + 1) % self.n_slots
        return np.asarray(freed[:need], dtype=np.int64)

    def _evict(self, slot: int) -> None:
        self.slot_state[slot] = FREE
        self.slot_vid[slot] = -1
        self.evictions += 1

    # ----------------------------------------------------------------- admit

    def admit(self, vids, exts, los, steps_, adjs, disk_pages) -> None:
        """Batch-admit fetched records (one affinity group / DMA batch)."""
        todo = [i for i, v in enumerate(vids) if self.record_map[v] < 0]
        if not todo:
            return
        free = np.nonzero(self.slot_state == FREE)[0]
        if len(free) < len(todo):
            extra = self.sweep(len(todo) - len(free))
            free = np.concatenate([free, extra])
        for i, slot in zip(todo, free[: len(todo)]):
            vid = int(vids[i])
            self.slot_state[slot] = LOCKED
            self.cache_ext[slot] = exts[i]
            self.cache_lo[slot] = los[i]
            self.cache_step[slot] = steps_[i]
            adj = adjs[i]
            self.cache_adj[slot, :] = -1
            self.cache_adj[slot, : len(adj)] = adj
            self.slot_vid[slot] = vid
            self.record_map[vid] = slot
            self.slot_state[slot] = OCCUPIED

    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0
