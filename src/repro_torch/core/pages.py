"""Slotted on-disk page layout for variable-size records (paper §3.3, Fig. 7).

Layout of one PAGE_SIZE-byte page:

    [ header 6B ][ slot array ->  ........  <- data heap ]

  header : Count u16 | HeapStart u16 | HeapUsed u16   (paper says 5B; we use 6
           for alignment — noted as an implementation liberty)
  slot   : VID u32 | Color u8 | Length u16 | StartOffset u16   = 9 bytes,
           sorted by VID for binary-search lookup
  heap   : record payloads, growing backward from the page end

"Two-way growth design achieves dense packing to fully utilize available page
space."  PageBuilder enforces exactly that invariant; fragmentation accounting
feeds benchmarks/bench_fragmentation.py (Fig. 6).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

PAGE_SIZE = 4096
HEADER_SIZE = 6
SLOT_SIZE = 9

_HDR = struct.Struct("<HHH")
_SLOT = struct.Struct("<IBHH")


@dataclasses.dataclass
class Slot:
    vid: int
    color: int
    length: int
    offset: int


class PageBuilder:
    """Packs variable-size records into one page; slots forward, heap backward."""

    def __init__(self, page_size: int = PAGE_SIZE):
        self.page_size = page_size
        self.entries: list[tuple[int, int, bytes]] = []  # (vid, color, payload)
        self._used = HEADER_SIZE

    def free_bytes(self) -> int:
        return self.page_size - self._used

    def fits(self, payload_len: int) -> bool:
        return self._used + SLOT_SIZE + payload_len <= self.page_size

    def add(self, vid: int, color: int, payload: bytes) -> bool:
        if not self.fits(len(payload)):
            return False
        self.entries.append((vid, color, payload))
        self._used += SLOT_SIZE + len(payload)
        return True

    def count(self) -> int:
        return len(self.entries)

    def finalize(self) -> bytes:
        buf = bytearray(self.page_size)
        entries = sorted(self.entries, key=lambda e: e[0])  # slots sorted by VID
        heap_ptr = self.page_size
        slots: list[Slot] = []
        for vid, color, payload in entries:
            heap_ptr -= len(payload)
            buf[heap_ptr : heap_ptr + len(payload)] = payload
            slots.append(Slot(vid, color, len(payload), heap_ptr))
        _HDR.pack_into(buf, 0, len(slots), heap_ptr, self.page_size - heap_ptr)
        off = HEADER_SIZE
        for s in slots:
            _SLOT.pack_into(buf, off, s.vid, s.color, s.length, s.offset)
            off += SLOT_SIZE
        return bytes(buf)


def page_count(page: bytes) -> int:
    return _HDR.unpack_from(page, 0)[0]


def page_slots(page: bytes) -> list[Slot]:
    count, _, _ = _HDR.unpack_from(page, 0)
    out = []
    off = HEADER_SIZE
    for _ in range(count):
        vid, color, length, offset = _SLOT.unpack_from(page, off)
        out.append(Slot(vid, color, length, offset))
        off += SLOT_SIZE
    return out


def page_lookup(page: bytes, vid: int) -> tuple[Slot, bytes] | None:
    """Binary search on the sorted slot array (paper: 'fast binary-search lookups')."""
    count, _, _ = _HDR.unpack_from(page, 0)
    lo, hi = 0, count - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        off = HEADER_SIZE + mid * SLOT_SIZE
        v, color, length, offset = _SLOT.unpack_from(page, off)
        if v == vid:
            s = Slot(v, color, length, offset)
            return s, page[offset : offset + length]
        if v < vid:
            lo = mid + 1
        else:
            hi = mid - 1
    return None


def page_records(page: bytes) -> list[tuple[Slot, bytes]]:
    return [(s, page[s.offset : s.offset + s.length]) for s in page_slots(page)]


def page_utilization(page: bytes) -> float:
    """Fraction of the page occupied by header+slots+heap (1 - internal frag)."""
    count, heap_start, heap_used = _HDR.unpack_from(page, 0)
    used = HEADER_SIZE + count * SLOT_SIZE + heap_used
    return used / len(page)


def fixed_layout_utilization(record_size: int, page_size: int = PAGE_SIZE) -> float:
    """Utilization of the DiskANN-style fixed-size-record layout (Fig. 6 oracle):
    floor(page/record) records per page, the remainder is internal fragmentation."""
    per_page = page_size // record_size
    if per_page == 0:
        # record spans multiple pages; fragmentation is the tail waste
        pages = (record_size + page_size - 1) // page_size
        return record_size / (pages * page_size)
    return per_page * record_size / page_size
