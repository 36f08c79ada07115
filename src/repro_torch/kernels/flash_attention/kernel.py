"""Launch wrapper for the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

The kernel replaces the Pallas TPU kernel ``_flash_kernel``.  Operations
bound it (4 Dh flops per visible query-key pair), so both input dtypes
multiply on the tensor cores.  bf16 inputs: one block per (128-row query
tile, head, sequence), K/V tiles brought in by TMA by a producer warp, two
consumer warpgroups doing Q K^T and P V with wgmma and the online softmax in
fp32 registers, P split into two bf16 terms so that the result stays within
one bf16 ulp of the fp32 plain version.  fp32 inputs: 3xTF32 on mma.sync
(every operand split into two TF32 terms, three products each), which one
TF32 pass could not do within the fp32 bar; 64-row query tiles, a cp.async
ring of K/V tiles, P kept in registers.  Both loop over only the key tiles
that the causal mask and the window leave visible and mask ragged edges in
the kernel (nothing is padded).  The wrapper validates its arguments, allocates the output and
launches on the current stream without synchronising.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0

HEAD_DIMS = (16, 32, 64, 128, 256)


def _check_cuda(name: str, t: torch.Tensor, dtype, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"flash_attention: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be a contiguous 4-d tensor")
    if t.data_ptr() % 16:  # read in 16-byte vectors
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned")


def flash_attention_cuda(
    q: torch.Tensor,   # (B, H, Sq, Dh) float32 or bfloat16
    k: torch.Tensor,   # (B, KVH, Skv, Dh) q's dtype
    v: torch.Tensor,   # (B, KVH, Skv, Dh) q's dtype
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, Sq, Dh) attention in q's dtype on the card, queries
    right-aligned to keys; a row that sees no key gets zeros."""
    global launches
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, q.dtype, dev)
    B, H, Sq, Dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, KVH, Skv, Dh) or v.shape != k.shape:
        raise ValueError("flash_attention: k and v must be (B, KVH, Skv, Dh) with q's B and Dh")
    if H % KVH or Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: needs H a multiple of KVH and Dh in {HEAD_DIMS}; "
                         f"got H={H}, KVH={KVH}, Dh={Dh}")
    if B > 65535 or H > 65535:
        raise ValueError("flash_attention: B and H must be at most 65535")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Skv == 0:  # no key at all: every row sees none
        return out.zero_()
    scale = scale if scale is not None else Dh**-0.5
    # a window wider than every (query, key) distance limits nothing; clamping
    # keeps position - window inside int32
    w = 0 if window is None else max(min(int(window), Skv + 1), -(Sq + Skv + 1))
    lib = _build.load()
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KVH, Sq, Skv, Dh,
        int(causal), int(window is not None), w, float(scale), dev.index,
        _build.stream(dev),
    )
    _build.check("flash_attention", err)
    launches += 1
    return out
