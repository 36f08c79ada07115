"""Plain PyTorch version of the 4-bit dequant + squared-L2 refinement kernel:
the CPU path and the oracle the CUDA kernel is held against."""

import torch


def unpack_nibbles(packed: torch.Tensor, d: int) -> torch.Tensor:
    """(N, d/2) uint8 -> (N, d) float32 codes in [0, 15] (low nibble = even dim)."""
    c = packed.to(torch.int32)
    inter = torch.stack([c & 0xF, (c >> 4) & 0xF], dim=-1).reshape(packed.shape[0], -1)
    return inter[:, :d].to(torch.float32)


def int4_dist2_ref(
    q: torch.Tensor,        # (B, d) rotated centered queries, float
    codes: torch.Tensor,    # (N, d/2) uint8 packed nibbles
    lo: torch.Tensor,       # (N,) per-record range low
    step: torch.Tensor,     # (N,) per-record step
) -> torch.Tensor:
    """||q_b - dequant(code_n)||^2 for every pair -> (B, N) float32."""
    qf = q.to(torch.float32)
    x = unpack_nibbles(codes, q.shape[1]) * step[:, None] + lo[:, None]  # (N, d)
    qn = (qf**2).sum(dim=1, keepdim=True)
    xn = (x**2).sum(dim=1)
    return qn - 2.0 * (qf @ x.T) + xn[None, :]
