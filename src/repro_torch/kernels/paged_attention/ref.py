"""Plain PyTorch version of decode attention through a KV block table: the
CPU path and the oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch


def paged_attention_ref(
    q: torch.Tensor,             # (B, H, Dh) one new token per sequence
    k_pages: torch.Tensor,       # (P, page, KVH, Dh) global KV page pool
    v_pages: torch.Tensor,       # (P, page, KVH, Dh)
    block_tables: torch.Tensor,  # (B, max_pages) int page ids (record_map analogue)
    context_lens: torch.Tensor,  # (B,) int tokens present per sequence
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, Dh) in q's dtype: softmax(q k^T * scale) v over the first
    ``context_lens[b]`` tokens of sequence b's pages, KV head ``h // (H/KVH)``
    for query head h, in float32.  A sequence with no token
    (``context_lens[b] <= 0``) gets zeros."""
    B, H, Dh = q.shape
    P, page, KVH, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    group = H // KVH
    scale = scale if scale is not None else Dh**-0.5

    # gather each sequence's logical KV: (B, max_pages*page, KVH, Dh)
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, max_pages * page, KVH, Dh)
    v = v_pages[bt].reshape(B, max_pages * page, KVH, Dh)

    kk = k.repeat_interleave(group, dim=2)  # (B, S, H, Dh)
    vv = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), kk.float())
    logits *= scale
    pos = torch.arange(max_pages * page, device=q.device)[None, :]
    mask = pos < context_lens.to(q.device).long()[:, None]
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bshd->bhd", p, vv.float())
    out = torch.where(mask.any(dim=-1)[:, None, None], out, 0.0)
    return out.to(q.dtype)
