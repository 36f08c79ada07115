"""Adjacency-list compression: delta-varint and partitioned Elias-Fano (paper §3.3).

The paper: "Adjacency lists are sorted and integer-compressed (e.g., delta
encoding or Partitioned Elias-Fano [38]) to reduce space consumption."

Both codecs operate on a sorted list of distinct uint32 vertex ids and are
exact (lossless); hypothesis round-trip tests live in tests/test_codec.py.
"""

from __future__ import annotations

import struct

import numpy as np

# --------------------------------------------------------------------------- varint


def _write_uvarint(out: bytearray, x: int) -> None:
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    x = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        x |= (b & 0x7F) << shift
        if not (b & 0x80):
            return x, pos
        shift += 7


def delta_encode(ids: np.ndarray) -> bytes:
    """Sorted distinct uint32 ids -> delta-gap varint bytes."""
    ids = np.asarray(ids, dtype=np.uint64)
    out = bytearray()
    _write_uvarint(out, len(ids))
    prev = -1
    for v in ids.tolist():
        gap = int(v) - prev - 1
        assert gap >= 0, "ids must be sorted and distinct"
        _write_uvarint(out, gap)
        prev = int(v)
    return bytes(out)


def delta_decode(buf: bytes) -> np.ndarray:
    m, pos = _read_uvarint(buf, 0)
    out = np.empty(m, dtype=np.uint32)
    prev = -1
    for i in range(m):
        gap, pos = _read_uvarint(buf, pos)
        prev = prev + 1 + gap
        out[i] = prev
    return out


# --------------------------------------------------------- partitioned Elias-Fano

_BLOCK = 64  # values per partition


def _ef_encode_block(vals: list[int], lo_base: int, universe: int) -> bytes:
    """Classic Elias-Fano over one block, relative to lo_base."""
    m = len(vals)
    assert m > 0
    u = max(universe - lo_base, 1)
    rel = [v - lo_base for v in vals]
    # number of low bits
    l = max(0, int(np.floor(np.log2(u / m))) if u > m else 0)
    low_mask = (1 << l) - 1

    bits = bytearray()
    bit_len = 0

    def push_bits(value: int, width: int) -> None:
        nonlocal bit_len
        for k in range(width):
            if bit_len % 8 == 0:
                bits.append(0)
            if (value >> k) & 1:
                bits[-1] |= 1 << (bit_len % 8)
            bit_len += 1

    # low halves, fixed width l
    for v in rel:
        push_bits(v & low_mask, l)
    # high halves, unary: for i-th value write (high_i - high_{i-1}) zeros then a one
    prev_hi = 0
    for v in rel:
        hi = v >> l
        push_bits(0, hi - prev_hi)
        push_bits(1, 1)
        prev_hi = hi

    header = struct.pack("<BH", l, m)
    return header + bytes(bits)


def _ef_decode_block(buf: bytes, pos: int, lo_base: int) -> tuple[list[int], int]:
    l, m = struct.unpack_from("<BH", buf, pos)
    pos += 3
    bit_pos = 0

    def read_bits(width: int) -> int:
        nonlocal bit_pos
        v = 0
        for k in range(width):
            byte = buf[pos + (bit_pos // 8)]
            if (byte >> (bit_pos % 8)) & 1:
                v |= 1 << k
            bit_pos += 1
        return v

    lows = [read_bits(l) for _ in range(m)]
    highs = []
    hi = 0
    for _ in range(m):
        while True:
            byte = buf[pos + (bit_pos // 8)]
            bit = (byte >> (bit_pos % 8)) & 1
            bit_pos += 1
            if bit:
                break
            hi += 1
        highs.append(hi)
    nbytes = (bit_pos + 7) // 8
    vals = [lo_base + (h << l | lo) for h, lo in zip(highs, lows)]
    return vals, pos + nbytes


def pef_encode(ids: np.ndarray) -> bytes:
    """Partitioned Elias-Fano: split sorted ids into blocks, each EF-coded
    against its own base — adapts to clustered id distributions, which is
    exactly what affinity-aware id assignment produces (paper §3.4 interacts
    with §3.3 here: co-placed records get nearby ids, shrinking gaps)."""
    ids = np.asarray(ids, dtype=np.uint64)
    out = bytearray()
    _write_uvarint(out, len(ids))
    if len(ids) == 0:
        return bytes(out)
    vals = [int(v) for v in ids.tolist()]
    nblocks = (len(vals) + _BLOCK - 1) // _BLOCK
    _write_uvarint(out, nblocks)
    for b in range(nblocks):
        chunk = vals[b * _BLOCK : (b + 1) * _BLOCK]
        lo_base = chunk[0]
        universe = chunk[-1] + 1
        _write_uvarint(out, lo_base)
        _write_uvarint(out, universe - lo_base)
        out += _ef_encode_block(chunk, lo_base, universe)
    return bytes(out)


def pef_decode(buf: bytes) -> np.ndarray:
    m, pos = _read_uvarint(buf, 0)
    if m == 0:
        return np.empty(0, dtype=np.uint32)
    nblocks, pos = _read_uvarint(buf, pos)
    vals: list[int] = []
    for _ in range(nblocks):
        lo_base, pos = _read_uvarint(buf, pos)
        _, pos = _read_uvarint(buf, pos)  # universe span (kept for skippable decode)
        chunk, pos = _ef_decode_block(buf, pos, lo_base)
        vals.extend(chunk)
    assert len(vals) == m
    return np.asarray(vals, dtype=np.uint32)


# ------------------------------------------------------------------- dispatcher

CODECS = {
    "delta": (delta_encode, delta_decode),
    "pef": (pef_encode, pef_decode),
}


def encode_adjacency(ids: np.ndarray, codec: str = "pef") -> bytes:
    ids = np.sort(np.asarray(ids, dtype=np.uint32))
    enc, _ = CODECS[codec]
    return enc(ids)


def decode_adjacency(buf: bytes, codec: str = "pef") -> np.ndarray:
    _, dec = CODECS[codec]
    return dec(buf)
