"""Public wrappers for binary_ip and the RaBitQ estimate around it: the CUDA
kernel for tensors on the card, the plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.binary_ip import kernel as _k
from repro_torch.kernels.binary_ip import ref as _ref


def _on_card(*tensors) -> bool:
    """Whether any of the tensors lies on a CUDA card (``is_cuda`` builds no
    ``torch.device``: this runs on every call of the search path)."""
    for t in tensors:
        if t is not None and t.is_cuda:
            return True
    return False


def binary_ip(
    q: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor | None = None
) -> torch.Tensor:
    """<q_b, sign_n> (B, N), with row n = ``codes[ids[n]]`` when ``ids`` is
    given.  When any tensor is on a CUDA card the kernel launches, and raises
    on what it does not take (a mix of devices among them); otherwise the
    plain version runs."""
    if _on_card(q, codes, ids):
        return _k.binary_ip_cuda(q, codes, ids)
    return _ref.binary_ip_ref(q, codes if ids is None else codes[ids])


def estimate_dist2(
    q: torch.Tensor,          # (B, d) rotated centered queries
    codes: torch.Tensor,      # (T, d/8) uint8
    norms: torch.Tensor,      # (T,)
    ip_bar: torch.Tensor,     # (T,)
    ids: torch.Tensor | None = None,  # (N,) int64 rows, or None for all T
) -> torch.Tensor:
    """RaBitQ level-1 estimated squared distances (B, N), with row n = row
    ``ids[n]`` of the tables when ``ids`` is given.

    Tensors on the card take one kernel launch for the whole estimate (the
    sign product, the query norms, the gathers and the norm corrections),
    with no PyTorch op before or after it; the kernel raises on what it does
    not take.  CPU tensors take the plain version."""
    if _on_card(q, codes, norms, ip_bar, ids):
        return _k.estimate_dist2_cuda(q, codes, norms, ip_bar, ids)
    qunit, qnorm = _ref.unit_queries(q)
    if ids is not None:
        norms, ip_bar = norms[ids], ip_bar[ids]
    g = binary_ip(qunit, codes, ids)
    return _ref.estimate_from_ip(g, qnorm, norms, ip_bar, q.shape[1])
