"""Public wrapper for paged decode attention: the CUDA kernel for tensors on
the card, the plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel as _k
from repro_torch.kernels.paged_attention import ref as _ref


def paged_attention(
    q: torch.Tensor,             # (B, H, Dh)
    k_pages: torch.Tensor,       # (P, page, KVH, Dh)
    v_pages: torch.Tensor,       # (P, page, KVH, Dh)
    block_tables: torch.Tensor,  # (B, max_pages) int
    context_lens: torch.Tensor,  # (B,) int
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention (B, H, Dh) in q's dtype through the block tables;
    ``scale`` defaults to ``Dh**-0.5``.  A sequence with no token gets zeros.
    CPU tensors take the plain version; anything else launches the kernel,
    which raises on what it does not take."""
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if all(t.device.type == "cpu" for t in tensors):
        return _ref.paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, scale)
    return _k.paged_attention_cuda(
        q, k_pages, v_pages, block_tables.to(torch.int32), context_lens.to(torch.int32), scale)
