"""Distributed vector search over a process group (the serving-scale plane).

The corpus is sharded across the group's ranks, one ``DeviceIndex`` each;
queries are replicated; each rank searches its local shard (scan mode or
graph mode); per-shard top-k merge via ``torch.distributed.all_gather`` +
global top-k — one small collective per batch.

Local ids are translated to global ids with each shard's base offset.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.velo import batch_search as bs
from repro_torch.velo import scan_search as ss
from repro_torch.velo.index import DeviceIndex


def local_search_fn(mode: str, L: int, k: int, max_steps: int):
    if mode == "scan":
        def run(index, queries):
            return ss.scan_search(index, queries, k=k, rerank=L)
    elif mode == "scan_ref":
        # the plain binary_ip_ref product in stage 1
        def run(index, queries):
            return ss.scan_search(index, queries, k=k, rerank=L, use_kernel=False)
    elif mode == "graph":
        def run(index, queries):
            ids, d2, _ = bs.batch_search(index, queries, L=L, k=k, max_steps=max_steps)
            return ids, d2
    else:
        raise ValueError(mode)
    return run


def mask_local_topk(
    ids: torch.Tensor, d2: torch.Tensor, offset: int | torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Translate one shard's local top-k to global ids, masking invalid lanes.

    Under-filled shards pad their local top-k with sentinel ids (< 0).  Adding
    the shard's base offset to a sentinel produces a VALID-LOOKING global id
    (offset - 1 etc.) that can win the merged top-k — so the mask must be
    applied to the LOCAL ids, before translation: invalid lanes keep id -1 and
    get distance +inf, which loses every top-k comparison after the gather.
    """
    valid = ids >= 0
    gids = torch.where(valid, ids.to(torch.int64) + offset, -1)
    d2 = torch.where(valid, d2, torch.inf)
    return gids, d2


def merge_topk(
    gids_all: torch.Tensor, d2_all: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over the gathered (B, S*k) candidate set; equal
    distances keep the lower column (the earlier shard) first."""
    d2, sel = ss.smallest(d2_all, k)
    return torch.gather(gids_all, 1, sel), d2


def make_distributed_search(
    group: dist.ProcessGroup | None = None,
    mode: str = "scan",
    L: int = 64,
    k: int = 10,
    max_steps: int = 96,
):
    """Builds a search over ``group`` (None: the default group): each rank
    calls it with (its shard's DeviceIndex, the shard's first global id,
    the replicated queries) and gets the global (ids (B, k), dist2 (B, k)),
    the shards' candidates concatenated in rank order before the merge."""
    local = local_search_fn(mode, L, k, max_steps)

    def searcher(index: DeviceIndex, offset: int, queries: torch.Tensor):
        ids, d2 = local(index, queries)                    # local shard results
        # (B, k) global ids, invalid lanes masked BEFORE the gather
        gids, d2 = mask_local_topk(ids, d2, offset)
        world = dist.get_world_size(group)
        gids_all = [torch.empty_like(gids) for _ in range(world)]
        d2_all = [torch.empty_like(d2) for _ in range(world)]
        dist.all_gather(gids_all, gids.contiguous(), group=group)
        dist.all_gather(d2_all, d2.contiguous(), group=group)
        return merge_topk(torch.cat(gids_all, dim=1), torch.cat(d2_all, dim=1), k)

    return searcher
