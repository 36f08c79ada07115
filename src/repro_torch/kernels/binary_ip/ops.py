"""Public wrappers for binary_ip: the CUDA kernel for tensors on the card,
the plain version for tensors on the CPU, and the estimator around it."""

from __future__ import annotations

import torch

from repro_torch.kernels.binary_ip import kernel as _k
from repro_torch.kernels.binary_ip import ref as _ref


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def binary_ip(
    q: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor | None = None
) -> torch.Tensor:
    """<q_b, sign_n> (B, N), with row n = ``codes[ids[n]]`` when ``ids`` is
    given.  CPU tensors take the plain version; anything else launches the
    kernel, which raises on what it does not take."""
    if _on_cpu(q, codes, ids):
        return _ref.binary_ip_ref(q, codes if ids is None else codes[ids])
    return _k.binary_ip_cuda(q, codes, ids)


def estimate_dist2(
    q: torch.Tensor,          # (B, d) rotated centered queries
    codes: torch.Tensor,      # (T, d/8) uint8
    norms: torch.Tensor,      # (T,)
    ip_bar: torch.Tensor,     # (T,)
    ids: torch.Tensor | None = None,  # (N,) int64 rows, or None for all T
) -> torch.Tensor:
    """RaBitQ level-1 estimated squared distances (B, N).

    The sign product runs in the kernel; the cheap per-element estimator
    (norm corrections) stays in PyTorch around it."""
    qunit, qnorm = _ref.unit_queries(q)
    if ids is not None:
        norms, ip_bar = norms[ids], ip_bar[ids]
    g = binary_ip(qunit, codes, ids)
    return _ref.estimate_from_ip(g, qnorm, norms, ip_bar, q.shape[1])
