"""Plain PyTorch version of multi-head attention with GQA and causal /
sliding-window masks: the CPU path and the oracle the CUDA kernel is held
against."""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,   # (B, H, Sq, Dh)
    k: torch.Tensor,   # (B, KVH, Skv, Dh)
    v: torch.Tensor,   # (B, KVH, Skv, Dh)
    causal: bool = True,
    window: int | None = None,   # sliding window size (None = full)
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, Sq, Dh) in q's dtype, float32 softmax.  Query row i sits at key
    position ``i + Skv - Sq`` (the last query aligned with the last key);
    causal keeps keys at or before it, a window keeps keys after
    ``position - window``.  A row that sees no key gets zeros."""
    B, H, Sq, Dh = q.shape
    KVH = k.shape[1]
    Skv = k.shape[2]
    if H % KVH:
        raise ValueError(f"attention_ref: H={H} must be a multiple of KVH={KVH}")
    group = H // KVH
    scale = scale if scale is not None else Dh**-0.5

    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float())
    logits = logits * scale

    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv.float())
    out = torch.where(mask.any(dim=-1)[:, None], out, 0.0)
    return out.to(q.dtype)
