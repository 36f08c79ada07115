"""Public wrapper for int4_dist: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.int4_dist import kernel as _k
from repro_torch.kernels.int4_dist import ref as _ref


def int4_dist2(
    q: torch.Tensor,        # (B, d)
    codes: torch.Tensor,    # (T, d/2) uint8
    lo: torch.Tensor,       # (T,)
    step: torch.Tensor,     # (T,)
    ids: torch.Tensor | None = None,  # (N,) int64 rows, or None for all T
) -> torch.Tensor:
    """Refined squared distances (B, N) from packed 4-bit codes, with row n =
    row ``ids[n]`` of the tables when ``ids`` is given.  When any tensor is
    on a CUDA card the kernel launches, and raises on what it does not take
    (a mix of devices among them); otherwise the plain version runs."""
    if (q.is_cuda or codes.is_cuda or lo.is_cuda or step.is_cuda
            or (ids is not None and ids.is_cuda)):
        return _k.int4_dist_cuda(q if q.dtype is torch.float32 else q.float(),
                                 codes, lo, step, ids)
    if ids is not None:
        codes, lo, step = codes[ids], lo[ids], step[ids]
    return _ref.int4_dist2_ref(q, codes, lo, step)
