"""The SSD-resident index image: page store + record formats.

Two physical formats, matching the paper's comparison setup (§5.2):

  * ``VeloIndex``  — compressed slotted layout: per-record payload is
        [ext_code d/2 B][lo f32][step f32][adj_len u16][compressed adjacency]
    packed by the affinity placement (repro_torch.core.placement).
  * ``FixedIndex`` — DiskANN-style layout: fixed-size records
        [vector d*4 B][degree u32][neighbor ids R*4 B]
    packed sequentially (DiskANN) or block-shuffled (Starling).

Both keep the level-1 RaBitQ artifacts resident (the paper standardizes RaBitQ
in-memory compression across all compared systems).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from repro_torch.core import codec as codec_mod
from repro_torch.core import placement as placement_mod
from repro_torch.core.pages import PAGE_SIZE, page_lookup, page_records
from repro_torch.core.quant import QuantizedBase, RabitQuantizer
from repro_torch.core.vamana import VamanaGraph


@dataclasses.dataclass
class DecodedRecord:
    vid: int
    adjacency: np.ndarray        # (deg,) int64
    # exactly one of the two payload kinds is set:
    ext_payload: bytes | None = None    # velo: 4-bit code + lo/step
    vector: np.ndarray | None = None    # diskann: full fp32 vector

    def nbytes(self) -> int:
        b = self.adjacency.nbytes + 16
        if self.ext_payload is not None:
            b += len(self.ext_payload)
        if self.vector is not None:
            b += self.vector.nbytes
        return b


class PageStore:
    """The simulated SSD: a flat array of pages. Reads are free here — latency
    is charged by the discrete-event simulator, not by this object."""

    def __init__(self, pages: list[bytes], page_size: int):
        self.pages = pages
        self.page_size = page_size

    def read_page(self, pid: int) -> bytes:
        return self.pages[pid]

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def disk_bytes(self) -> int:
        return len(self.pages) * self.page_size

    def shard_bytes(self, page_shard: "np.ndarray") -> "np.ndarray":
        """Per-shard disk footprint under a page->shard assignment
        (core.sharding): how evenly the scatter-gather plane splits the index
        image across the engine shards.  The balance diagnostic the sharded
        benchmark reports alongside scaling efficiency."""
        assert len(page_shard) == len(self.pages)
        n_shards = int(page_shard.max()) + 1 if len(page_shard) else 0
        counts = np.bincount(
            np.asarray(page_shard, dtype=np.int64), minlength=n_shards
        )
        return counts * self.page_size


# ------------------------------------------------------------------ VeloIndex


class VeloIndex:
    """Compressed slotted index with affinity co-placement."""

    def __init__(
        self,
        base: np.ndarray,
        graph: VamanaGraph,
        qb: QuantizedBase,
        adj_codec: str = "pef",
        page_size: int = PAGE_SIZE,
        tau_scale: float = 1.0,   # 0 disables co-placement (tau=0 in Fig. 13)
        affine_cap: int | None = None,
    ):
        self.n, self.dim = base.shape
        self.graph = graph
        self.qb = qb
        self.adj_codec = adj_codec
        self.page_size = page_size

        self._payload_cache: dict[int, bytes] = {}

        def payload_fn(vid: int) -> bytes:
            if vid not in self._payload_cache:
                adj = np.sort(graph.neighbors(vid).astype(np.uint32))
                enc = codec_mod.encode_adjacency(adj, adj_codec)
                self._payload_cache[vid] = (
                    qb.record_payload(vid) + struct.pack("<H", len(enc)) + enc
                )
            return self._payload_cache[vid]

        if affine_cap is None and self.n:
            # paper §3.4: "We set the affinity bound k relative to page
            # capacity to prevent affinity groups from spanning multiple
            # pages." — estimate records/page from a payload sample.
            sample = [len(payload_fn(v)) + 9 for v in range(0, self.n, max(1, self.n // 64))]
            per_page = max(2, (page_size - 6) // max(1, int(np.mean(sample))))
            affine_cap = per_page - 1
        affinity = graph.affinity_ids(tau_scale=tau_scale, cap=affine_cap)
        self.layout = placement_mod.layout_affinity(
            payload_fn, self.n, affinity, page_size
        )
        self.store = PageStore(self.layout.pages, page_size)
        self._payload_cache.clear()

    # -- record access -------------------------------------------------------

    def page_of(self, vid: int) -> int:
        return int(self.layout.vid_to_page[vid])

    def color_of(self, vid: int) -> int:
        return int(self.layout.colors[vid])

    def decode_record(self, vid: int, page: bytes) -> DecodedRecord:
        hit = page_lookup(page, vid)
        assert hit is not None, f"vid {vid} not on its mapped page"
        _, payload = hit
        return self._decode_payload(vid, payload)

    def _decode_payload(self, vid: int, payload: bytes) -> DecodedRecord:
        ext_len = (self.dim // 2 if self.qb.ext_bits == 4 else self.dim) + 8
        ext = payload[:ext_len]
        (adj_len,) = struct.unpack_from("<H", payload, ext_len)
        adj = codec_mod.decode_adjacency(
            payload[ext_len + 2 : ext_len + 2 + adj_len], self.adj_codec
        )
        return DecodedRecord(vid=vid, adjacency=adj.astype(np.int64), ext_payload=ext)

    def co_resident_records(self, vid: int, page: bytes) -> list[DecodedRecord]:
        """Paper §3.4: 'Upon accessing any record with a non-zero Color tag, all
        co-tagged records on the page are proactively fetched into the buffer
        pool.'"""
        color = self.color_of(vid)
        if color == 0:
            return []
        out = []
        for slot, payload in page_records(page):
            if slot.color == color and slot.vid != vid:
                out.append(self._decode_payload(slot.vid, payload))
        return out

    def refine_dist2(self, pq, rec: DecodedRecord) -> float:
        return RabitQuantizer.refine_dist2_from_payload(self.qb, pq, rec.ext_payload)

    # -- batch access (the distance plane's record-group path) ---------------

    def record_matrix(
        self, recs: list[DecodedRecord]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stack fetched records' level-2 payloads into batch-decodable arrays:
        packed codes (m, d/2 or d) uint8 + per-row lo/step (m,) float32."""
        ncode = self.dim // 2 if self.qb.ext_bits == 4 else self.dim
        buf = np.frombuffer(
            b"".join(r.ext_payload for r in recs), dtype=np.uint8
        ).reshape(len(recs), ncode + 8)
        codes = buf[:, :ncode]
        tail = np.ascontiguousarray(buf[:, ncode:]).view(np.float32)  # (m, 2)
        return codes, tail[:, 0].copy(), tail[:, 1].copy()

    def refine_records(self, engine, pq, recs: list[DecodedRecord]) -> np.ndarray:
        """Level-2 refinement of a fetched record group in one engine call."""
        if not recs:
            return np.empty(0, dtype=np.float32)
        codes, lo, step = self.record_matrix(recs)
        return engine.refine(self.qb, pq, codes, lo, step)

    def refine_payload(self, recs: list[DecodedRecord], resident: bool = True):
        """(kind, payload) of the ScoreRequest refining this record group:
        quantized records refine on the extended-code path.  The resident
        wire format carries only the vertex ids — the engine gathers the
        rows from its registered level-2 table (on-device for torch);
        ``resident=False`` materializes the (codes, lo, step) matrices from
        the fetched payload bytes (the host-gather parity path).  The two
        are bitwise interchangeable: tests assert the on-disk payloads
        round-trip to exactly the build-time code tables."""
        if resident:
            return "refine", np.asarray([r.vid for r in recs], dtype=np.int64)
        return "refine", self.record_matrix(recs)

    # -- accounting (Table 3) --------------------------------------------------

    def disk_bytes(self) -> int:
        return self.store.disk_bytes()

    def resident_bytes(self) -> int:
        return self.qb.resident_bytes() + self.layout.vid_to_page.nbytes + self.layout.colors.nbytes


# ----------------------------------------------------------------- FixedIndex


class FixedIndex:
    """DiskANN-style fixed-size-record index (also Starling's when shuffled)."""

    def __init__(
        self,
        base: np.ndarray,
        graph: VamanaGraph,
        qb: QuantizedBase,
        page_size: int = PAGE_SIZE,
        shuffle: bool = False,
    ):
        self.n, self.dim = base.shape
        self.graph = graph
        self.qb = qb
        self.page_size = page_size
        self.R = graph.R
        self.record_size = self.dim * 4 + 4 + self.R * 4

        self.per_page = max(1, page_size // self.record_size)

        if shuffle:
            order = self._bfs_order(graph)
        else:
            order = np.arange(self.n, dtype=np.int64)

        self.vid_to_page = np.empty(self.n, dtype=np.int32)
        self.vid_to_slot = np.empty(self.n, dtype=np.int32)
        pages: list[bytes] = []
        buf = bytearray()
        count = 0
        for vid in order:
            vid = int(vid)
            self.vid_to_page[vid] = len(pages)
            self.vid_to_slot[vid] = count
            vec = base[vid].astype(np.float32).tobytes()
            adj = graph.neighbors(vid).astype(np.int32)
            padded = np.full(self.R, -1, dtype=np.int32)
            padded[: len(adj)] = adj
            buf += vec + struct.pack("<i", len(adj)) + padded.tobytes()
            count += 1
            if count == self.per_page:
                buf += b"\x00" * (page_size - len(buf))
                pages.append(bytes(buf))
                buf = bytearray()
                count = 0
        if count:
            buf += b"\x00" * ((-len(buf)) % page_size)
            pages.append(bytes(buf))
        self.store = PageStore(pages, page_size)
        # record ids resident in each page (for Starling block search)
        self.page_members: list[list[int]] = [[] for _ in pages]
        for vid in range(self.n):
            self.page_members[self.vid_to_page[vid]].append(vid)

    @staticmethod
    def _bfs_order(graph: VamanaGraph) -> np.ndarray:
        from collections import deque

        n = graph.n
        seen = np.zeros(n, dtype=bool)
        order: list[int] = []
        for s in range(n):
            if seen[s]:
                continue
            dq = deque([s])
            seen[s] = True
            while dq:
                v = dq.popleft()
                order.append(v)
                for u in graph.neighbors(v):
                    u = int(u)
                    if not seen[u]:
                        seen[u] = True
                        dq.append(u)
        return np.asarray(order, dtype=np.int64)

    def page_of(self, vid: int) -> int:
        return int(self.vid_to_page[vid])

    def color_of(self, vid: int) -> int:
        return 0

    def decode_record(self, vid: int, page: bytes) -> DecodedRecord:
        slot = int(self.vid_to_slot[vid])
        off = slot * self.record_size
        vec = np.frombuffer(page, dtype=np.float32, count=self.dim, offset=off)
        (deg,) = struct.unpack_from("<i", page, off + self.dim * 4)
        adj = np.frombuffer(
            page, dtype=np.int32, count=self.R, offset=off + self.dim * 4 + 4
        )[:deg]
        return DecodedRecord(vid=vid, adjacency=adj.astype(np.int64), vector=vec)

    def co_resident_records(self, vid: int, page: bytes) -> list[DecodedRecord]:
        return []

    def page_record_ids(self, pid: int) -> list[int]:
        return self.page_members[pid]

    def refine_dist2(self, pq, rec: DecodedRecord) -> float:
        diff = rec.vector.astype(np.float32) - pq.q_orig
        return float(diff @ diff)

    # -- batch access (the distance plane's record-group path) ---------------

    def record_matrix(self, recs: list[DecodedRecord]) -> np.ndarray:
        """Stack fetched records' fp32 vectors into one (m, d) matrix."""
        return np.stack([r.vector for r in recs]).astype(np.float32, copy=False)

    def refine_records(self, engine, pq, recs: list[DecodedRecord]) -> np.ndarray:
        """Exact fp32 refinement of a fetched record group in one engine call."""
        if not recs:
            return np.empty(0, dtype=np.float32)
        return engine.refine_full(pq.q_orig, self.record_matrix(recs))

    def refine_payload(self, recs: list[DecodedRecord], resident: bool = True):
        """(kind, payload) of the ScoreRequest refining this record group:
        DiskANN-style records carry full fp32 vectors (nothing quantized is
        resident, so ``resident`` does not apply)."""
        return "full", self.record_matrix(recs)

    def disk_bytes(self) -> int:
        return self.store.disk_bytes()

    def resident_bytes(self) -> int:
        return self.qb.resident_bytes() + self.vid_to_page.nbytes + self.vid_to_slot.nbytes
