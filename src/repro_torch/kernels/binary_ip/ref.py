"""Plain PyTorch versions of the binary inner-product kernel: the CPU path
and the oracle the CUDA kernel is held against."""

import math

import torch


def unpack_signs(codes: torch.Tensor, d: int) -> torch.Tensor:
    """(N, d/8) uint8 (little-endian bits) -> (N, d) {-1,+1} float32."""
    shifts = torch.arange(8, dtype=torch.int32, device=codes.device)
    bits = (codes.to(torch.int32)[:, :, None] >> shifts) & 1  # (N, d/8, 8)
    bits = bits.reshape(codes.shape[0], -1)[:, :d]
    return (2 * bits - 1).to(torch.float32)


def binary_ip_ref(q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """<q_b, sign_n> for every query x code row.

    q:     (B, d) float
    codes: (N, d/8) uint8 (np.packbits bitorder='little')
    out:   (B, N) float32
    """
    signs = unpack_signs(codes, q.shape[1])
    return q.to(torch.float32) @ signs.T


def estimate_from_ip(
    g_raw: torch.Tensor,      # (B, N) <q_unit, sign_n>
    qnorm: torch.Tensor,      # (B, 1)
    norms: torch.Tensor,      # (N,)
    ip_bar: torch.Tensor,     # (N,)
    d: int,
) -> torch.Tensor:
    """RaBitQ's estimator around the sign product: the norm corrections."""
    g = g_raw / math.sqrt(d)
    est_cos = torch.clamp(g / torch.clamp_min(ip_bar[None, :], 1e-6), -1.0, 1.0)
    return qnorm**2 + norms[None, :] ** 2 - 2.0 * qnorm * norms[None, :] * est_cos


def unit_queries(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q / max(||q||, 1e-12), ||q||) per row, in float32."""
    qf = q.to(torch.float32)
    qnorm = torch.linalg.vector_norm(qf, dim=1, keepdim=True)
    return qf / torch.clamp_min(qnorm, 1e-12), qnorm


def estimate_dist2_ref(
    q: torch.Tensor,          # (B, d) rotated centered queries
    codes: torch.Tensor,      # (N, d/8) uint8
    norms: torch.Tensor,      # (N,)
    ip_bar: torch.Tensor,     # (N,)
) -> torch.Tensor:
    """Full RaBitQ level-1 distance estimate (matches core.quant's NumPy path)."""
    qunit, qnorm = unit_queries(q)
    return estimate_from_ip(
        binary_ip_ref(qunit, codes), qnorm, norms, ip_bar, q.shape[1]
    )
