"""Launch wrapper for the CUDA ``scan_select`` kernel (``csrc/scan_select.cu``).

One launch is scan_search's stage-1 epilogue of one chunk: from
``binary_ip``'s (B, L) fp32 product it forms the bf16 level-1 estimates and
merges each row's C smallest into the running carry, bit for bit what the
plain chain of ``ref.scan_select_ref`` returns.  The per-query and per-row
operands are rounded once a call in PyTorch (``tables``).  The wrapper
checks each tensor, allocates the new carry, launches on the current stream
without synchronising and raises when the launch is refused.  ``launches``
counts the launches on the host; the kernel itself adds, once a block, the
(row, chunk) pairs that took its full select rather than its filter to a
device counter that is read only on request (``full_select_rows``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0
MAX_C = 4096  # the most candidates a row the kernel keeps

_F32, _BF16, _I64 = torch.float32, torch.bfloat16, torch.int64
_LAUNCH = tracing.name("kernels.launch")
_full_rows: dict[int, torch.Tensor] = {}  # device index -> (1,) int64 counter on that card


def tables(qnorm: torch.Tensor, norms: torch.Tensor,
           ip_bar: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The estimator's per-query and per-row operands, each bf16 one rounded
    by the op that rounds it in ``ref.estimate``: qtab (B, 2) bf16 holds
    qn**2 and 2.0 * qn (qn = bf16(qnorm)); ipb (N,) bf16 is
    bf16(max(ip_bar, 1e-6)); rtab (N, 2) int32 holds the fp32 bits of
    y = 1 / ipb (NaN where y is not a normal number: those columns take the
    IEEE division) and the bf16 pair nr = bf16(norms), nr**2."""
    qn = qnorm.reshape(-1).to(_BF16)
    qtab = torch.stack([qn**2, 2.0 * qn], dim=1)
    nr = norms.to(_BF16)
    ipb = torch.clamp_min(ip_bar, 1e-6).to(_BF16)
    y = torch.reciprocal(ipb.float())
    y = torch.where(y.abs() >= 2.0**-126, y, torch.nan)
    pair = torch.stack([nr, nr**2], dim=1).view(torch.int32)[:, 0]
    rtab = torch.stack([y.view(torch.int32), pair], dim=1)
    return qtab, rtab, ipb


def inv_sqrt(d: int) -> float:
    """fp32(1) / fp32(sqrt(d)): what PyTorch's CUDA division by the Python
    scalar sqrt(d) multiplies by."""
    return float(np.float32(1.0) / np.float32(math.sqrt(d)))


def _counter(index: int) -> torch.Tensor:
    t = _full_rows.get(index)
    if t is None:
        t = _full_rows[index] = torch.zeros(1, dtype=_I64, device=index)
    return t


def full_select_rows() -> int:
    """The (row, chunk) pairs that took the full select since the count was
    last reset, over every card used: reads the cards (a synchronisation)."""
    return sum(int(t.item()) for t in _full_rows.values())


def reset_full_select_rows() -> None:
    for t in _full_rows.values():
        t.zero_()


def _refuse(name: str, t: torch.Tensor, what: str, shape: tuple, index: int) -> ValueError:
    where = "a CUDA device" if index < 0 else f"cuda:{index}"
    return ValueError(f"scan_select: {name} must be a contiguous {what} tensor of shape {shape} "
                      f"on {where}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def scan_select_cuda(
    g: torch.Tensor,          # (B, L) float32: binary_ip of the chunk
    qtab: torch.Tensor,       # (B, 2) bfloat16, from tables
    rtab: torch.Tensor,       # (L, 2) int32: the chunk's rows of tables' rtab
    ipb: torch.Tensor,        # (L,) bfloat16: the chunk's rows of tables' ipb
    d: int,
    C: int,
    row0: int = 0,
    carry: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, C) bf16, (B, C) int64
) -> tuple[torch.Tensor, torch.Tensor]:
    """The new carry (values (B, C) bf16, ids (B, C) int64) on the card:
    ``ref.scan_select_ref`` of the same chunk.  A carry is sorted in each
    row as this function and ``ref.merge`` leave it; without one, C <= L.
    Raises ValueError on what the kernel does not take."""
    global launches
    sp = tracing.begin(_LAUNCH) if tracing.on else -1
    index = g.get_device()
    if g.dim() != 2:
        raise _refuse("g", g, "float32", ("B", "L"), index)
    B, L = g.shape
    checks = [("g", g, _F32, (B, L)), ("qtab", qtab, _BF16, (B, 2)),
              ("rtab", rtab, torch.int32, (L, 2)), ("ipb", ipb, _BF16, (L,))]
    if carry is not None:
        checks += [("carry values", carry[0], _BF16, (B, C)), ("carry ids", carry[1], _I64, (B, C))]
    for name, t, dtype, shape in checks:
        if (index < 0 or t.get_device() != index or t.dtype is not dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise _refuse(name, t, str(dtype), shape, index)
    if not 1 <= C <= MAX_C or (carry is None and C > L):
        raise ValueError(f"scan_select: C={C} must be in [1, {MAX_C}], and at most L={L} "
                         f"without a carry")
    if B == 0 or L == 0 or row0 < 0 or row0 + L > 1 << 32:
        raise ValueError(f"scan_select: B={B} and L={L} must be positive and the chunk's ids "
                         f"[{row0}, {row0 + L}) within [0, 2**32)")
    vals = torch.empty((B, C), dtype=_BF16, device=index)
    ids = torch.empty((B, C), dtype=_I64, device=index)
    cv, ci = (None, None) if carry is None else (carry[0].data_ptr(), carry[1].data_ptr())
    err = _build.load().scan_select_bf16(
        g.data_ptr(), qtab.data_ptr(), rtab.data_ptr(), ipb.data_ptr(), cv, ci, vals.data_ptr(),
        ids.data_ptr(),
        _counter(index).data_ptr(), B, L, C, row0, inv_sqrt(d), index, _build.stream(index),
    )
    if err:
        _build.check("scan_select", err)
    launches += 1
    if sp >= 0:
        tracing.end(sp)
    return vals, ids
