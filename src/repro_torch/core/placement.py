"""Affinity-based record co-placement + baseline layouts (paper §3.4).

Produces the physical page image of the index:
  * ``layout_affinity``    — VeloANN: affinity groups co-placed with Color tags;
                             pages padded with non-affine records; sets split
                             across page boundaries only as a last resort.
  * ``layout_sequential``  — DiskANN-style: records packed by ascending id.
  * ``layout_block_shuffle`` — Starling-style: BFS-over-graph ordering so that
                             graph-adjacent vertices share pages (the paper
                             argues this pollutes pages vs. affinity grouping).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from collections.abc import Callable

import numpy as np

from repro_torch.core.pages import PAGE_SIZE, PageBuilder


@dataclasses.dataclass
class Layout:
    pages: list[bytes]
    vid_to_page: np.ndarray   # (n,) int32
    colors: np.ndarray        # (n,) uint8 — 0 = non-affine
    page_size: int

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def disk_bytes(self) -> int:
        return self.n_pages * self.page_size


PayloadFn = Callable[[int], bytes]


def shard_pages(n_pages: int, n_shards: int) -> np.ndarray:
    """Assign pages to engine shards: contiguous balanced ranges.

    Pages are the atomic sharding unit because the affinity layout never
    splits an affinity group across pages except as a last resort (§3.4) — so
    page-granular sharding preserves the co-placement property that one fetch
    serves many hops, now against the shard that owns the data.  Contiguous
    ranges additionally keep affinity-adjacent PAGES (placed back-to-back by
    the greedy fill) on one shard.  ``shard_of[p] = floor(p * S / P)`` gives
    every shard ``P/S`` pages within one of each other, deterministically.
    """
    assert n_shards >= 1
    if n_pages == 0:
        return np.empty(0, dtype=np.int32)
    return (
        (np.arange(n_pages, dtype=np.int64) * n_shards) // n_pages
    ).astype(np.int32)


def _flush(builder: PageBuilder, pages: list[bytes]) -> PageBuilder:
    if builder.count():
        pages.append(builder.finalize())
    return PageBuilder(builder.page_size)


def layout_affinity(
    payload_fn: PayloadFn,
    n: int,
    affinity: dict[int, list[int]],
    page_size: int = PAGE_SIZE,
) -> Layout:
    """Paper §3.4 'Affinity-based Record Co-Placement', faithfully:

    'We co-locate the affine records by iterating over the affinity dictionary
    and placing the sets contiguously on disk. ... each set receives a unique
    nonzero [Color], incremented cyclically; 0 denotes non-affine records.
    Pages are filled greedily. If a set does not fit in the remaining space, we
    first pad the residual space with non-affine records. If none are
    available, we split the set across page boundaries.'
    """
    placed = np.zeros(n, dtype=bool)
    vid_to_page = np.full(n, -1, dtype=np.int32)
    colors = np.zeros(n, dtype=np.uint8)
    pages: list[bytes] = []

    affine_members: set[int] = set()
    for p, group in affinity.items():
        affine_members.add(p)
        affine_members.update(group)
    non_affine = deque(v for v in range(n) if v not in affine_members)

    builder = PageBuilder(page_size)
    color_counter = 0

    def next_color() -> int:
        nonlocal color_counter
        color_counter = color_counter % 255 + 1  # cyclic 1..255
        return color_counter

    def place(vid: int, color: int) -> None:
        nonlocal builder
        payload = payload_fn(vid)
        if not builder.add(vid, color, payload):
            builder = _flush(builder, pages)
            ok = builder.add(vid, color, payload)
            assert ok, f"record {vid} larger than a page"
        placed[vid] = True
        vid_to_page[vid] = len(pages)  # page index once flushed == current count
        colors[vid] = color

    def pad_with_non_affine() -> None:
        """Fill the residual space of the current page with non-affine records."""
        nonlocal builder
        scanned = 0
        while non_affine and scanned < len(non_affine):
            vid = non_affine[0]
            if placed[vid]:
                non_affine.popleft()
                continue
            if builder.fits(len(payload_fn(vid))):
                non_affine.popleft()
                place(vid, 0)
                scanned = 0
            else:
                break

    for p in sorted(affinity.keys()):
        group = [p] + [v for v in affinity[p] if not placed[v] and v != p]
        group = [v for v in group if not placed[v]]
        if not group:
            continue
        group_bytes = sum(len(payload_fn(v)) + 9 for v in group)
        if group_bytes > builder.free_bytes():
            # paper: pad the residual with non-affine records first ...
            pad_with_non_affine()
            # ... and if none are available, SPLIT the set across the page
            # boundary rather than waste the residual (place() below flushes
            # exactly when the next member no longer fits).
        color = next_color() if len(group) > 1 else 0
        for v in group:
            place(v, color)

    # remaining non-affine records (and any affine members never reached)
    for vid in range(n):
        if not placed[vid]:
            place(vid, 0)
    builder = _flush(builder, pages)

    # fix page ids for records placed into the final builder of each flush:
    # place() recorded len(pages) *before* flush, which is correct because
    # flush appends exactly once after the page fills; verify:
    assert vid_to_page.min() >= 0 and vid_to_page.max() < len(pages)
    return Layout(pages=pages, vid_to_page=vid_to_page, colors=colors, page_size=page_size)


def layout_sequential(
    payload_fn: PayloadFn, n: int, page_size: int = PAGE_SIZE
) -> Layout:
    """Pack slotted records by ascending id (no affinity signal)."""
    pages: list[bytes] = []
    vid_to_page = np.full(n, -1, dtype=np.int32)
    colors = np.zeros(n, dtype=np.uint8)
    builder = PageBuilder(page_size)
    for vid in range(n):
        payload = payload_fn(vid)
        if not builder.add(vid, 0, payload):
            builder = _flush(builder, pages)
            assert builder.add(vid, 0, payload)
        vid_to_page[vid] = len(pages)
    builder = _flush(builder, pages)
    return Layout(pages=pages, vid_to_page=vid_to_page, colors=colors, page_size=page_size)


def layout_block_shuffle(
    payload_fn: PayloadFn,
    n: int,
    adjacency: np.ndarray,
    degrees: np.ndarray,
    page_size: int = PAGE_SIZE,
) -> Layout:
    """Starling-style topology-driven ordering: BFS over the proximity graph so
    graph-adjacent vertices land on the same page."""
    order: list[int] = []
    seen = np.zeros(n, dtype=bool)
    for start in range(n):
        if seen[start]:
            continue
        dq = deque([start])
        seen[start] = True
        while dq:
            v = dq.popleft()
            order.append(v)
            for u in adjacency[v, : degrees[v]]:
                u = int(u)
                if u >= 0 and not seen[u]:
                    seen[u] = True
                    dq.append(u)

    pages: list[bytes] = []
    vid_to_page = np.full(n, -1, dtype=np.int32)
    colors = np.zeros(n, dtype=np.uint8)
    builder = PageBuilder(page_size)
    for vid in order:
        payload = payload_fn(vid)
        if not builder.add(vid, 0, payload):
            builder = _flush(builder, pages)
            assert builder.add(vid, 0, payload)
        vid_to_page[vid] = len(pages)
    builder = _flush(builder, pages)
    return Layout(pages=pages, vid_to_page=vid_to_page, colors=colors, page_size=page_size)
