"""Launch wrapper for the CUDA ``binary_ip`` kernel (``csrc/binary_ip.cu``).

The kernel replaces the Pallas TPU kernel ``_binary_ip_kernel``: one thread
per code row, the id gather folded into the row load, IEEE fp32 FMA.  The
wrapper validates its arguments, allocates the output and launches on the
current stream without synchronising.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"binary_ip: {name} must be on {device}, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"binary_ip: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"binary_ip: {name} must be a contiguous {ndim}-d tensor")


def binary_ip_cuda(
    q: torch.Tensor,                    # (B, d) float32 or bfloat16
    codes: torch.Tensor,                # (T, d/8) uint8
    ids: torch.Tensor | None = None,    # (N,) int64 rows of codes, or None
) -> torch.Tensor:
    """(B, N) float32 <q_b, sign(codes[ids[n]])> on the card (N = T when
    ``ids`` is None).  An id outside ``[0, T)`` yields NaN in its column."""
    global launches
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"binary_ip: q must be float32 or bfloat16, got {q.dtype}")
    _check_cuda("q", q, None, 2, dev)
    _check_cuda("codes", codes, torch.uint8, 2, dev)
    B, d = q.shape
    if d % 8 or codes.shape[1] * 8 != d:
        raise ValueError(f"binary_ip: d={d} must be a multiple of 8 and "
                         f"codes must be (T, d/8), got {tuple(codes.shape)}")
    if ids is not None:
        _check_cuda("ids", ids, torch.int64, 1, dev)
    N = codes.shape[0] if ids is None else ids.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out
    lib = _build.load()
    fn = lib.binary_ip_f32 if q.dtype == torch.float32 else lib.binary_ip_bf16
    err = fn(
        q.data_ptr(), codes.data_ptr(),
        None if ids is None else ids.data_ptr(), out.data_ptr(),
        B, N, d, codes.shape[0], dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("binary_ip", err)
    launches += 1
    return out
