"""HBM record-cache tier: device-resident hot records above the host pool.

The paper keeps hot records close to the compute while the cold tail drains
through the async buffer pool; NDSEARCH (PAPERS.md) makes the same argument
from the hardware side — move distance work to where the data lives instead
of shipping data to the compute.  This module wires the two existing halves
together into a real second cache tier:

  * ``repro_torch.velo.device_cache.DeviceRecordCache`` supplies the slot state —
    record-map indirection, vectorized clock sweep, LOCKED/OCCUPIED/MARKED —
    as the host mirror of the device arrays;
  * the resident distance plane supplies the zero-upload gather: a
    refine request whose vids map to cache slots is served by a
    slot-indirection gather from ``cache_ext``/``cache_lo``/``cache_step``
    (``DistanceEngine.refine_slots``), never by re-uploading payload bytes.

Tier protocol (all host-driven, lockstep with the engine):

  lookup path   ``RecordAccessor`` consults the tier BEFORE the host pool:
                ``lookup(vid)`` rebuilds the full ``DecodedRecord`` (payload
                bytes bit-identical to the on-disk record, adjacency from
                ``cache_adj``) on a hit; a miss falls through to the pool and
                from there to the async LOCKED-window load protocol.
  admission     the pool's ``on_publish`` hook hands every freshly installed
                record to ``note_publish`` (warm-up: staged while the tier
                has free slots); a host-pool HIT on a non-tier-resident
                record calls ``note_hit`` (steady state: proven-hot records
                are promoted even when staging forces an eviction sweep).
  scatter       staged records are installed by ONE batched scatter at the
                next dispatch boundary (``scatter_staged``) — the
                double-buffered DMA the paper overlaps with the fused kernel
                of the concurrent step.  The engine charges
                ``max(0, CostModel.hbm_scatter_s - dispatch_s)``: only the
                part of the DMA the dispatch could not hide.

With the tier disabled nothing here is constructed and every caller takes
its original code path — the bitwise-parity contract tests pin down.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import CacheSlotView, QuantizedBase
from repro_torch.core.store import DecodedRecord
from repro_torch.velo.device_cache import (
    DeviceRecordCache,
    FREE,
    LOCKED,
    MARKED,
    OCCUPIED,
)


class HbmTier:
    """The engine-facing handle on one ``DeviceRecordCache``.

    Vid namespace: whatever the paired ``RecordBufferPool`` uses — local vids
    for a single system, global (base-shifted) vids on the serving plane's
    shared pool.  ``HbmView`` translates a tenant's local vids into this
    namespace.
    """

    def __init__(self, qb: QuantizedBase, vid_to_page: np.ndarray,
                 n_slots: int, R: int):
        dim = qb.dim
        code_cols = qb.ext_codes.shape[1]
        self.qb = qb
        self.cache = DeviceRecordCache.create(
            n_slots, np.asarray(vid_to_page), dim=dim, R=R,
            code_cols=code_cols,
        )
        self.view = CacheSlotView(
            qb=qb,
            ext=self.cache.cache_ext,
            lo=self.cache.cache_lo,
            step=self.cache.cache_step,
        )
        self._ncode = code_cols
        self._R = R
        self.scatters = 0
        # records parsed and waiting for the next dispatch-boundary scatter
        self._staged: list[tuple[int, np.ndarray, float, float, np.ndarray]] = []
        self._staged_set: set[int] = set()
        self._dev = None  # lazy device mirror of (ext, lo, step)
        # host-pool hit counts since last staging; once the tier is full a
        # record must prove itself hot (promote_after pool hits) before its
        # promotion may evict an installed slot — single touches never churn
        self.promote_after = 4
        self._hot_counts: dict[int, int] = {}

    # ------------------------------------------------------------- residency

    def ready(self, vid: int) -> bool:
        """The record can be served from a slot right now (installed, not in
        a scatter's LOCKED window) — the tier analogue of peek_present."""
        slot = int(self.cache.record_map[vid])
        return slot >= 0 and self.cache.slot_state[slot] != LOCKED

    def lookup(self, vid: int, out_vid: int | None = None) -> DecodedRecord | None:
        """Serve a full record from its cache slot, or None.

        Rebuilds the exact on-disk form: payload bytes are codes + f32 lo +
        f32 step (bit-identical to ``QuantizedBase.record_payload`` — the
        roundtrip tests pin this), adjacency is the slot's ``cache_adj`` row
        with the -1 padding stripped.  Counts a tier hit/miss and gives
        MARKED slots their second chance, mirroring the pool's lookup.
        ``out_vid`` sets the vid on the rebuilt record (a serving-plane view
        passes the tenant-local vid while addressing by global vid)."""
        slot = int(self.cache.record_map[vid])
        if slot < 0 or self.cache.slot_state[slot] == LOCKED:
            self.cache.misses += 1
            return None
        if self.cache.slot_state[slot] == MARKED:
            self.cache.slot_state[slot] = OCCUPIED  # second chance
        self.cache.hits += 1
        codes = self.cache.cache_ext[slot]
        payload = (
            codes.tobytes()
            + np.float32(self.cache.cache_lo[slot]).tobytes()
            + np.float32(self.cache.cache_step[slot]).tobytes()
        )
        row = self.cache.cache_adj[slot]
        adj = row[row >= 0].astype(np.int64)
        return DecodedRecord(
            vid=vid if out_vid is None else out_vid,
            adjacency=adj,
            ext_payload=payload,
        )

    def peek_split(
        self, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Partition a refine id vector into (hit_mask, slot indices of the
        hits) for the flush-time slot gather.  NO hit/miss counting — these
        records were already counted when the searcher fetched them; this is
        the dispatch plane re-resolving residency, not a new access.  MARKED
        slots still get their second chance (a gather is a touch).  Returns
        None when nothing is resident."""
        slots = self.cache.record_map[ids]
        mask = slots >= 0
        if mask.any():
            hit_slots = slots[mask]
            locked = self.cache.slot_state[hit_slots] == LOCKED
            if locked.any():
                keep = np.nonzero(mask)[0][locked]
                mask[keep] = False
                hit_slots = slots[mask]
            if not mask.any():
                return None
            marked = self.cache.slot_state[hit_slots] == MARKED
            self.cache.slot_state[hit_slots[marked]] = OCCUPIED
            return mask, hit_slots.astype(np.int64)
        return None

    def covers(self, qb) -> bool:
        return qb is self.qb

    # ------------------------------------------------------------- admission

    def _free_headroom(self) -> int:
        used = int((self.cache.slot_state != FREE).sum())
        return self.cache.n_slots - used - len(self._staged)

    def _stage(self, vid: int, rec) -> bool:
        if (
            vid in self._staged_set
            or self.cache.record_map[vid] >= 0
            or getattr(rec, "ext_payload", None) is None
            or len(rec.adjacency) > self._R
        ):
            return False
        payload = rec.ext_payload
        codes = np.frombuffer(payload[: self._ncode], dtype=np.uint8)
        lo = float(np.frombuffer(payload[self._ncode:self._ncode + 4],
                                 dtype=np.float32)[0])
        step = float(np.frombuffer(payload[self._ncode + 4:self._ncode + 8],
                                   dtype=np.float32)[0])
        self._staged.append(
            (vid, codes, lo, step, rec.adjacency.astype(np.int32))
        )
        self._staged_set.add(vid)
        return True

    def note_publish(self, vid: int, rec) -> None:
        """Pool publication hook (the miss-list handoff): stage the freshly
        loaded record for the next scatter, but only while the tier still has
        free slots — cold-tail records never evict an installed one."""
        if self._free_headroom() > 0:
            self._stage(int(vid), rec)

    def note_hit(self, vid: int, rec) -> None:
        """Host-pool hit on a record the tier doesn't hold: promote it once
        it has proven hot.  While the tier has free slots promotion is
        immediate; once full, a record needs ``promote_after`` pool hits
        before its staging may evict an installed slot — otherwise the cold
        tail would churn the tier on every touch and the scatter DMA (plus
        the evictions) would eat the win."""
        vid = int(vid)
        if self._free_headroom() > 0:
            self._stage(vid, rec)
            return
        n = self._hot_counts.get(vid, 0) + 1
        if n >= self.promote_after:
            if self._stage(vid, rec):
                self._hot_counts.pop(vid, None)
                return
        self._hot_counts[vid] = n

    # --------------------------------------------------------------- scatter

    def scatter_staged(self) -> int:
        """Install every staged record in ONE batched admit + device scatter
        (the double-buffered DMA).  Returns the number of slots written; the
        caller charges ``hbm_scatter_s`` net of the dispatch it overlapped."""
        if not self._staged:
            return 0
        staged, self._staged = self._staged, []
        self._staged_set.clear()
        vids = np.asarray([s[0] for s in staged], dtype=np.int64)
        exts = np.stack([s[1] for s in staged])
        los = np.asarray([s[2] for s in staged], dtype=np.float32)
        steps = np.asarray([s[3] for s in staged], dtype=np.float32)
        adjs = [s[4] for s in staged]
        self.cache.admit(
            vids, exts, los, steps, adjs,
            disk_pages=self.cache.disk_pages[vids],
        )
        installed = self.cache.record_map[vids]
        written = installed[installed >= 0].astype(np.int64)
        if len(written) == 0:
            return 0
        if self._dev is not None:
            # In-place index_copy_ on the device mirror replaces the reference's
            # functional ``.at[slots].set`` scatter: the mirror belongs to this
            # tier alone, and a slot gather already enqueued on the stream
            # reads the slots before this copy overwrites them.
            slots = torch.from_numpy(written).to(self._dev[0].device)
            for mirror, host in zip(self._dev, (self.cache.cache_ext,
                                                self.cache.cache_lo,
                                                self.cache.cache_step)):
                rows = torch.from_numpy(host[written]).to(mirror.device)
                mirror.index_copy_(0, slots, rows)
        self.scatters += 1
        return int(len(written))

    def device_arrays(self, device):
        """Device mirror of (cache_ext, cache_lo, cache_step) for the torch
        slot-gather — moved to ``device`` once, then maintained in place by
        the scatter; the per-hop path never re-uploads slot contents."""
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(a).to(device, copy=True)
                for a in (self.cache.cache_ext, self.cache.cache_lo,
                          self.cache.cache_step)
            )
        return self._dev

    # --------------------------------------------------------------- gathers

    def gather(
        self, slots: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.view.gather(slots)

    # ------------------------------------------------------------ accounting

    def counters(self) -> dict[str, int]:
        return {
            "hits": self.cache.hits,
            "misses": self.cache.misses,
            "evictions": self.cache.evictions,
            "scatters": self.scatters,
        }

    def nbytes(self) -> int:
        c = self.cache
        return (
            c.cache_ext.nbytes + c.cache_lo.nbytes + c.cache_step.nbytes
            + c.cache_adj.nbytes + c.slot_state.nbytes + c.slot_vid.nbytes
        )

    def hit_rate(self) -> float:
        return self.cache.hit_rate()


class HbmView:
    """A tenant's window onto a shared ``HbmTier``: translates local vids to
    the tier's global namespace and keeps per-view hit/miss counters so the
    serving plane can split tier traffic by tenant (mirror of
    ``TenantPoolView``)."""

    def __init__(self, tier: HbmTier, vid_base: int = 0):
        self.tier = tier
        self.vid_base = int(vid_base)
        self.hits = 0
        self.misses = 0

    def ready(self, vid: int) -> bool:
        return self.tier.ready(vid + self.vid_base)

    def lookup(self, vid: int) -> DecodedRecord | None:
        rec = self.tier.lookup(vid + self.vid_base, out_vid=vid)
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def note_hit(self, vid: int, rec) -> None:
        self.tier.note_hit(vid + self.vid_base, rec)
