"""Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit) and
the least time a kernel could take, copied from ``chip_smoke.py::bound_ms``:
each input byte read once and each output byte written once at the HBM
rate, or the useful operations at the peak of the units the kernel
multiplies on, whichever is longer."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def bound_s(nbytes: float, flops: float, flop_per_s: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def binary_ip_bound_s(B: int, N: int, d: int, q_bytes: int = 2) -> float:
    """One ``binary_ip`` launch over N packed rows of d signs for B queries
    (bf16 queries on the tensor cores, as the scan's stage 1 launches it):
    2 B N d operations at the bf16 peak; the codes N d / 8 bytes, the
    queries B d ``q_bytes`` and the (B, N) float32 output once each."""
    nbytes = N * d // 8 + B * d * q_bytes + B * N * 4
    return bound_s(nbytes, 2 * B * N * d, BF16_FLOP_PER_S)[0]
