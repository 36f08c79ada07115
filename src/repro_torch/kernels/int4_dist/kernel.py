"""Launch wrapper for the CUDA ``int4_dist`` kernel (``csrc/int4_dist.cu``).

The kernel replaces the Pallas TPU kernel ``_int4_dist_kernel``: one thread
per code row, the id (or HBM-slot) gather folded into the row load, the
dequant in registers, IEEE fp32 FMA.  The wrapper validates its arguments,
allocates the output and launches on the current stream without
synchronising.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"int4_dist: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"int4_dist: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"int4_dist: {name} must be a contiguous {ndim}-d tensor")


def int4_dist_cuda(
    q: torch.Tensor,                    # (B, d) float32
    codes: torch.Tensor,                # (T, d/2) uint8, low nibble = even dim
    lo: torch.Tensor,                   # (T,) float32
    step: torch.Tensor,                 # (T,) float32
    ids: torch.Tensor | None = None,    # (N,) int64 rows of codes, or None
) -> torch.Tensor:
    """(B, N) float32 ||q_b - (code*step + lo)[ids[n]]||^2 on the card
    (N = T when ``ids`` is None).  An id outside ``[0, T)`` yields NaN."""
    global launches
    dev = q.device
    _check_cuda("q", q, torch.float32, 2, dev)
    _check_cuda("codes", codes, torch.uint8, 2, dev)
    _check_cuda("lo", lo, torch.float32, 1, dev)
    _check_cuda("step", step, torch.float32, 1, dev)
    B, d = q.shape
    T = codes.shape[0]
    if d % 8 or codes.shape[1] * 2 != d:
        raise ValueError(f"int4_dist: d={d} must be a multiple of 8 and "
                         f"codes must be (T, d/2), got {tuple(codes.shape)}")
    if lo.shape[0] != T or step.shape[0] != T:
        raise ValueError("int4_dist: lo and step must have one entry per code row")
    if codes.data_ptr() % 4:
        raise ValueError("int4_dist: codes must be 4-byte aligned")
    if ids is not None:
        _check_cuda("ids", ids, torch.int64, 1, dev)
    N = T if ids is None else ids.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out
    lib = _build.load()
    err = lib.int4_dist_f32(
        q.data_ptr(), codes.data_ptr(), lo.data_ptr(), step.data_ptr(),
        None if ids is None else ids.data_ptr(), out.data_ptr(),
        B, N, d, T, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("int4_dist", err)
    launches += 1
    return out
