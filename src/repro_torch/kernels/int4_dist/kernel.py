"""Launch wrapper for the CUDA ``int4_dist`` kernel (``csrc/int4_dist.cu``).

The kernel replaces the Pallas TPU kernel ``_int4_dist_kernel``.  At the
search path's shape (B <= 8 queries x 64-256 gathered ids, d = 128) a call
is latency: two dependent loads on the card (the id, then the code row) and,
around them, this wrapper's host time, which was several times the kernel's.
So the kernel spreads each code row over several lanes, issues its loads
before anything else and dequantises algebraically (see the source), and the
wrapper checks each tensor once, takes the raw stream from ``_build.stream``
and passes q through without a copy.  It allocates the output with
``torch.empty`` and launches on the current stream without synchronising.
With ``repro_torch.tracing`` on, each call is a ``kernels.launch`` span.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0


_F32, _U8, _I64 = torch.float32, torch.uint8, torch.int64
_LAUNCH = tracing.name("kernels.launch")  # checks, output allocation, the launch


def _refuse(name: str, t: torch.Tensor, dtype, ndim: int, index: int) -> ValueError:
    where = "a CUDA device" if index < 0 else f"cuda:{index}"
    return ValueError(f"int4_dist: {name} must be a contiguous {ndim}-d {dtype} tensor on "
                      f"{where}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def int4_dist_cuda(
    q: torch.Tensor,                    # (B, d) float32
    codes: torch.Tensor,                # (T, d/2) uint8, low nibble = even dim
    lo: torch.Tensor,                   # (T,) float32
    step: torch.Tensor,                 # (T,) float32
    ids: torch.Tensor | None = None,    # (N,) int64 rows of codes, or None
) -> torch.Tensor:
    """(B, N) float32 ||q_b - (code*step + lo)[ids[n]]||^2 on the card
    (N = T when ``ids`` is None).  An id outside ``[0, T)`` yields NaN.

    Every check reads plain attributes (``get_device`` gives an int, no
    ``torch.device`` is built): at the search path's shape this call's host
    time, not the kernel, is what a caller waits for."""
    global launches
    sp = tracing.begin(_LAUNCH) if tracing.on else -1
    index = q.get_device()  # -1 on the CPU
    for name, t, dtype, ndim in (("q", q, _F32, 2), ("codes", codes, _U8, 2),
                                 ("lo", lo, _F32, 1), ("step", step, _F32, 1),
                                 ("ids", ids, _I64, 1)):
        if t is not None and (index < 0 or t.get_device() != index or t.dtype is not dtype
                              or t.dim() != ndim or not t.is_contiguous()):
            raise _refuse(name, t, dtype, ndim, index)
    B, d = q.shape
    T, half = codes.shape
    if d % 8 or half * 2 != d:
        raise ValueError(f"int4_dist: d={d} must be a multiple of 8 and "
                         f"codes must be (T, d/2), got {tuple(codes.shape)}")
    if lo.shape[0] != T or step.shape[0] != T:
        raise ValueError("int4_dist: lo and step must have one entry per code row")
    codes_ptr = codes.data_ptr()
    if codes_ptr % 4:
        raise ValueError("int4_dist: codes must be 4-byte aligned")
    N = T if ids is None else ids.shape[0]
    out = torch.empty((B, N), dtype=_F32, device=index)
    if B == 0 or N == 0:
        if sp >= 0:
            tracing.end(sp)
        return out
    err = _build.load().int4_dist_f32(
        q.data_ptr(), codes_ptr, lo.data_ptr(), step.data_ptr(),
        None if ids is None else ids.data_ptr(), out.data_ptr(),
        B, N, d, T, index, _build.stream(index),
    )
    if err:
        _build.check("int4_dist", err)
    launches += 1
    if sp >= 0:
        tracing.end(sp)
    return out
