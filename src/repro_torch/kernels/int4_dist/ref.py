"""Plain PyTorch version of the 4-bit dequant + squared-L2 refinement kernel:
the CPU path and the oracle the CUDA kernel is held against."""

import torch

from repro_torch.kernels import pair_rows


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
    """||q_b - dequant(code_n)||^2 for every pair -> (B, N) float32.

    Each entry is its own reduction over d of the squared difference (the
    NumPy batch engine's form), so it is bit for bit the same whatever other
    queries and rows share the call."""
    B, d = q.shape
    qf = q.to(torch.float32)[:, None, :]
    out = torch.empty((B, codes.shape[0]), dtype=torch.float32, device=q.device)
    n = pair_rows(B, d)
    for s in range(0, codes.shape[0], n):
        x = unpack_nibbles(codes[s:s + n], d) * step[s:s + n, None] + lo[s:s + n, None]
        diff = qf - x[None]
        out[:, s:s + n] = (diff * diff).sum(-1)
    return out
