"""Plain PyTorch versions of scan_search's stage-1 epilogue: the CPU path,
the card path under ``use_kernel=False``, and the oracle the CUDA kernel
``scan_select`` is held against.

The level-1 estimate of one chunk is computed in bf16, op by op, with the
reference's casts (``estimate``); the running top-C is a stable ascending
sort and a cut (``smallest``), so that equal bf16 estimates are taken in
lower-row order, as ``jax.lax.top_k`` takes them; a chunk's top-C is merged
with the carry by concatenating [carry | chunk] and cutting again
(``merge``)."""

from __future__ import annotations

import math

import torch


def smallest(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest values of each row and their column indices, equal
    values in lower-index order (``jax.lax.top_k(-x, k)``'s selection)."""
    order = torch.argsort(x, dim=1, stable=True)[:, :k]
    return torch.gather(x, 1, order), order


def estimate(g: torch.Tensor, qnorm: torch.Tensor, norms: torch.Tensor, ip_bar: torch.Tensor,
             d: int) -> torch.Tensor:
    """Level-1 estimates (B, L) bf16 of one chunk from its sign product g
    (B, L) fp32 of the bf16 unit queries, qnorm (B, 1) and the chunk's
    norms and ip_bar (L,)."""
    g = (g / math.sqrt(d)).to(torch.bfloat16)
    ipb = torch.clamp_min(ip_bar[None, :], 1e-6).to(torch.bfloat16)
    est_cos = torch.clamp(g / ipb, -1.0, 1.0)
    nr = norms[None, :].to(torch.bfloat16)
    qn = qnorm.to(torch.bfloat16)
    return qn**2 + nr**2 - 2.0 * qn * nr * est_cos


def merge(best_d: torch.Tensor, best_i: torch.Tensor, dc: torch.Tensor, ic: torch.Tensor,
          C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The C smallest of [carry | candidates] by value, the carry first
    among equals: the new carry (values, ids)."""
    all_d = torch.cat([best_d, dc], dim=1)
    all_i = torch.cat([best_i, ic], dim=1)
    best_d, sel = smallest(all_d, C)
    return best_d, torch.gather(all_i, 1, sel)


def scan_select_ref(
    g: torch.Tensor,          # (B, L) fp32 sign product of the chunk
    qnorm: torch.Tensor,      # (B, 1) fp32
    norms: torch.Tensor,      # (L,) the chunk's rows
    ip_bar: torch.Tensor,     # (L,)
    d: int,
    C: int,
    row0: int = 0,            # global id of the chunk's first row
    carry: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, C) bf16, (B, C) int64
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk's C smallest estimates, merged with ``carry`` when given:
    (values (B, C) bf16, global ids (B, C) int64).  Without a carry, C is at
    most L."""
    est = estimate(g, qnorm, norms, ip_bar, d)
    dc, sel = smallest(est, C)
    if carry is None:
        return dc, sel + row0
    return merge(carry[0], carry[1], dc, sel + row0, C)
