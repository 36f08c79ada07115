"""Public wrapper for prefill attention: the CUDA kernel for tensors on the
card, the plain version for tensors on the CPU.

The JAX op pads both lengths to tiles and masks the padding; the CUDA kernel
masks ragged edges itself, so nothing is padded here.  Either way every real
query row gets the same result."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(
    q: torch.Tensor,   # (B, H, Sq, Dh)
    k: torch.Tensor,   # (B, KVH, Skv, Dh)
    v: torch.Tensor,   # (B, KVH, Skv, Dh)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention (B, H, Sq, Dh) in q's dtype with GQA (head h reads KV head
    ``h // (H/KVH)``), causal and sliding-window masks, queries right-aligned
    to keys, ``scale`` defaulting to ``Dh**-0.5``.  A row that sees no key
    (causal with Sq > Skv) gets zeros.  CPU tensors take the plain version;
    anything else launches the kernel, which raises on what it does not
    take."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    return _k.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
