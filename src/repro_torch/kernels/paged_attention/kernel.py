"""Launch wrapper for the CUDA ``paged_attention`` kernel
(``csrc/paged_attention.cu``).

The kernel replaces the Pallas TPU kernel ``_paged_kernel``: one block per
(sequence, KV head) holding that head's whole query group, a loop over only
the pages the sequence has, page ids read from the block table by the block
itself, an IEEE fp32 online softmax.  The wrapper validates its arguments,
allocates the output and launches on the current stream without
synchronising.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0

MAX_HEAD_DIM = 256
MAX_GROUP = 32          # query heads per KV head
MAX_GROUP_ELEMS = 4096  # group * head_dim: the accumulator held in registers


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"paged_attention: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"paged_attention: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"paged_attention: {name} must be a contiguous {ndim}-d tensor")
    if ndim == 4 and t.data_ptr() % 16:  # the pages are read in 16-byte vectors
        raise ValueError(f"paged_attention: {name} must be 16-byte aligned")


def paged_attention_cuda(
    q: torch.Tensor,             # (B, H, Dh) float32 or bfloat16
    k_pages: torch.Tensor,       # (P, page, KVH, Dh) q's dtype
    v_pages: torch.Tensor,       # (P, page, KVH, Dh) q's dtype
    block_tables: torch.Tensor,  # (B, max_pages) int32
    context_lens: torch.Tensor,  # (B,) int32
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, Dh) decode attention in q's dtype on the card.  Tokens past
    ``min(context_lens[b], max_pages * page)`` are never read; a sequence
    with no token gets zeros; a page id outside ``[0, P)`` gives NaN for
    that sequence's KV head."""
    global launches
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: q must be float32 or bfloat16, got {q.dtype}")
    _check_cuda("q", q, q.dtype, 3, dev)
    _check_cuda("k_pages", k_pages, q.dtype, 4, dev)
    _check_cuda("v_pages", v_pages, q.dtype, 4, dev)
    _check_cuda("block_tables", block_tables, torch.int32, 2, dev)
    _check_cuda("context_lens", context_lens, torch.int32, 1, dev)
    B, H, Dh = q.shape
    P, page, KVH, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    if k_pages.shape[3] != Dh or v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: k_pages and v_pages must be (P, page, KVH, Dh)")
    if block_tables.shape[0] != B or context_lens.shape[0] != B:
        raise ValueError("paged_attention: block_tables and context_lens need one row per sequence")
    if H % KVH:
        raise ValueError(f"paged_attention: H={H} must be a multiple of KVH={KVH}")
    group = H // KVH
    vec = 16 // q.element_size()
    if Dh % vec or Dh > MAX_HEAD_DIM or group > MAX_GROUP or group * Dh > MAX_GROUP_ELEMS:
        raise ValueError(
            f"paged_attention: needs Dh a multiple of {vec} and <= {MAX_HEAD_DIM}, "
            f"H/KVH <= {MAX_GROUP} and H/KVH*Dh <= {MAX_GROUP_ELEMS}; got Dh={Dh}, "
            f"H/KVH={group}")
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    scale = scale if scale is not None else Dh**-0.5
    lib = _build.load()
    fn = lib.paged_attention_f32 if q.dtype == torch.float32 else lib.paged_attention_bf16
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), B, H, KVH, Dh, page, max_pages, P,
        float(scale), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("paged_attention", err)
    launches += 1
    return out
