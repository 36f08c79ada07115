"""Public wrapper for scan_search's stage-1 chunk epilogue: the CUDA kernel
for tensors on the card, the plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.scan_select import kernel as _k
from repro_torch.kernels.scan_select import ref as _ref


def scan_select(
    g: torch.Tensor,          # (B, L) fp32 sign product of the chunk
    qnorm: torch.Tensor,      # (B, 1) fp32
    norms: torch.Tensor,      # (L,) the chunk's rows
    ip_bar: torch.Tensor,     # (L,)
    d: int,
    C: int,
    row0: int = 0,
    carry: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``ref.scan_select_ref``: the chunk's bf16 level-1 estimates and the
    new carry of its C smallest (values, global ids).  On the card one
    launch after the operands are rounded (``kernel.tables``); the kernel
    raises on what it does not take.  CPU tensors take the plain version."""
    if g.is_cuda:
        return _k.scan_select_cuda(g, *_k.tables(qnorm, norms, ip_bar), d, C, row0, carry)
    return _ref.scan_select_ref(g, qnorm, norms, ip_bar, d, C, row0, carry)
