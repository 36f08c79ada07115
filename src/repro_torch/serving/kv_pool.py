"""Paged KV block pool — the record-level buffer pool (paper §3.2) for serving.

The mapping:
  vertex record          -> KV page (page_size tokens of one sequence's K/V)
  record mapping array   -> per-request block table (logical page -> physical)
  slot state machine     -> page states FREE/OCCUPIED/MARKED with a clock hand
  'SSD tier'             -> host swap: evicted pages spill to a host store and
                            reload on access (the larger-than-HBM serving mode)

The pool is the single physical (P, page, KVH, dh) K/V tensor pair that
kernels/paged_attention consumes; block tables index into it — the same
hybrid-pointer indirection the ANN engine uses for records.  Only the page
tensors live on the pool's device; the page states, owners, clock hand,
block tables and counters are host NumPy / Python state, and the swap store
holds CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

FREE, OCCUPIED, MARKED = 0, 2, 3  # matches bufferpool's state ids
TABLE_PASSES = 8  # batch_block_tables gives up after this many passes


@dataclasses.dataclass
class Request:
    rid: int
    block_table: list[int]          # logical page -> physical page (-1 = swapped)
    context_len: int = 0
    done: bool = False


class PagedKVPool:
    """Physical page pool + per-request block tables + clock eviction.

    Evicted pages spill to a host-side store keyed (rid, logical_page) and are
    reloaded (possibly into a different physical page) on access — exactly the
    paper's record load path with the page id swapped for a swap key.  The
    pages are ``dtype`` tensors on ``device`` (the process default, the card,
    when None)."""

    def __init__(self, n_pages: int, page_size: int, kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None):
        self.page_size = page_size
        self.n_pages = n_pages
        self.device = resolve_device(device)
        self.dtype = dtype
        shape = (n_pages, page_size, kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.state = np.full(n_pages, FREE, np.int8)
        self.owner = np.full((n_pages, 2), -1, np.int64)   # (rid, logical_page)
        self.hand = 0
        self.requests: dict[int, Request] = {}
        self.swap: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.swap_ins = 0
        self.table_repasses = 0  # batch_block_tables' passes beyond the first

    # ------------------------------------------------------------- requests

    def add_request(self, rid: int) -> Request:
        req = Request(rid=rid, block_table=[])
        self.requests[rid] = req
        return req

    def finish_request(self, rid: int) -> None:
        req = self.requests.pop(rid)
        req.done = True
        for pp in req.block_table:
            if pp >= 0:
                self._free_page(pp)
        for key in [k for k in self.swap if k[0] == rid]:
            del self.swap[key]

    # ---------------------------------------------------------------- pages

    def _free_page(self, pp: int) -> None:
        self.state[pp] = FREE
        self.owner[pp] = (-1, -1)

    def _alloc_page(self) -> int:
        free = np.nonzero(self.state == FREE)[0]
        if len(free):
            pp = int(free[0])
        else:
            pp = self._clock_evict()
        self.state[pp] = OCCUPIED
        return pp

    def _clock_evict(self) -> int:
        """Clock second-chance over physical pages; victim spills to host."""
        for _ in range(3 * self.n_pages):
            pp = self.hand
            self.hand = (self.hand + 1) % self.n_pages
            st = self.state[pp]
            if st == OCCUPIED:
                self.state[pp] = MARKED
            elif st == MARKED:
                rid, lp = (int(x) for x in self.owner[pp])
                # copy=True: on a CPU pool .to("cpu") would alias the page,
                # and the next write to this physical page would change it
                self.swap[(rid, lp)] = (
                    self.k_pages[pp].to("cpu", copy=True),
                    self.v_pages[pp].to("cpu", copy=True),
                )
                if rid in self.requests and lp < len(self.requests[rid].block_table):
                    self.requests[rid].block_table[lp] = -1
                self._free_page(pp)
                self.evictions += 1
                return pp
        raise RuntimeError("clock failed: all pages pinned")

    def _touch(self, pp: int) -> None:
        if self.state[pp] == MARKED:
            self.state[pp] = OCCUPIED  # second chance

    # ----------------------------------------------------------------- write

    def append_token(self, rid: int, k, v) -> None:
        """Append one token's K/V (kv_heads, head_dim), NumPy arrays or
        tensors, cast to the pool's dtype, to the request."""
        req = self.requests[rid]
        lp = req.context_len // self.page_size
        off = req.context_len % self.page_size
        if lp >= len(req.block_table):
            req.block_table.append(self._alloc_page())
            self.owner[req.block_table[lp]] = (rid, lp)
        pp = self.ensure_resident(rid, lp)
        self.k_pages[pp, off] = torch.as_tensor(k).to(self.device, self.dtype)
        self.v_pages[pp, off] = torch.as_tensor(v).to(self.device, self.dtype)
        req.context_len += 1

    # ---------------------------------------------------------------- access

    def is_resident(self, rid: int, lp: int) -> bool:
        req = self.requests[rid]
        return lp < len(req.block_table) and req.block_table[lp] >= 0

    def residency_fraction(self, rid: int) -> float:
        req = self.requests[rid]
        if not req.block_table:
            return 1.0
        return sum(p >= 0 for p in req.block_table) / len(req.block_table)

    def ensure_resident(self, rid: int, lp: int) -> int:
        """The load path: hit -> touch; miss -> alloc page + swap-in."""
        req = self.requests[rid]
        pp = req.block_table[lp]
        if pp >= 0:
            self._touch(pp)
            self.hits += 1
            return pp
        self.misses += 1
        pp = self._alloc_page()
        k, v = self.swap.pop((rid, lp))
        self.k_pages[pp].copy_(k)  # a copy into the page: the store's tensor is dropped
        self.v_pages[pp].copy_(v)
        self.owner[pp] = (rid, lp)
        req.block_table[lp] = pp
        self.swap_ins += 1
        return pp

    def block_table_array(self, rid: int, max_pages: int) -> np.ndarray:
        """Materialize a dense block table for the paged_attention kernel,
        swapping in any non-resident page (the demand path)."""
        req = self.requests[rid]
        out = np.zeros(max_pages, np.int32)
        for lp in range(len(req.block_table)):
            out[lp] = self.ensure_resident(rid, lp)
        return out

    def batch_block_tables(self, rids: list[int], max_pages: int) -> np.ndarray:
        """The (len(rids), max_pages) block tables of one decode batch.

        ``block_table_array`` swaps pages in one request at a time and the
        clock pins nothing, so a swap-in for a later request may evict a page
        that an earlier request's table already names.  The tables are built
        again, by the same calls, until every one equals its request's block
        table; each pass beyond the first is counted in ``table_repasses``.
        Raises ``RuntimeError`` when ``TABLE_PASSES`` passes do not settle
        (the batch's pages do not fit the pool together)."""
        for extra in range(TABLE_PASSES):
            tables = np.stack([self.block_table_array(r, max_pages) for r in rids])
            if all(np.array_equal(t[: len(self.requests[r].block_table)],
                                  self.requests[r].block_table) for r, t in zip(rids, tables)):
                self.table_repasses += extra
                return tables
        raise RuntimeError(f"the batch's block tables did not settle in {TABLE_PASSES} passes")

    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 1.0
