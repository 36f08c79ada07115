"""Launch wrapper for the CUDA ``paged_attention`` kernel
(``csrc/paged_attention.cu``).

The kernel replaces the Pallas TPU kernel ``_paged_kernel``: the context
is split into runs of ``split_tokens`` tokens (``split_tokens`` below), one
block per (KV head, sequence, run) holding that head's whole query group
(or, where the group is too wide for one block's registers, one chunk of
it: ``head_chunks`` below),
page ids read from the block table by the block itself, K/V chunks
pipelined through shared memory, bf16 pages multiplied on the tensor cores
(P split into two bf16 terms), fp32 pages in IEEE fp32 on the CUDA cores,
an fp32 online softmax; with more than one run, a second kernel of the same
call combines the runs' partial states.  The wrapper validates its arguments, allocates the output and the
scratch of partial states and launches on the current stream without
synchronising.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0  # wrapper calls that launched, since the caller last set it to 0

HEAD_DIMS = (16, 32, 64, 128, 256)  # compile-time head widths of the kernel
MAX_GROUP_ELEMS = 4096  # heads of a block * head_dim: the accumulators held in registers
MAX_GROUP_HEADS = 32    # heads of a block
SMS = 132         # streaming multiprocessors of an H100 SXM
WAVES = 4         # blocks a sequence's runs aim for, in units of SMS (2 bf16 blocks fit an SM)
CHUNK = 64        # tokens a block stages in shared memory at a time (bf16)
MIN_SPLIT = 256   # no run shorter than this: each run pays a partial state


def split_tokens(B: int, KVH: int, max_tokens: int, page: int) -> int:
    """Tokens of each run of the context split, for B sequences of at most
    ``max_tokens`` tokens (``max_pages * page``) and KVH KV heads.  The rule:
    ask for ``ceil(WAVES * SMS / (B * KVH))`` runs a sequence, so that the
    grid holds at least four waves of blocks on the card's SMs (two resident
    blocks an SM, twice over); make each run
    ``max_tokens / runs`` tokens rounded down to a multiple of the page and
    of ``CHUNK`` (so that there are at least that many runs), but never
    shorter than ``MIN_SPLIT`` rounded up to such a multiple (where the
    contexts do not allow the runs).  The runs ``[i * split, (i + 1) *
    split)``, ``i < ceil(max_tokens / split)``, cover every token exactly
    once; the context lengths are not read, so choosing costs no copy from
    the card."""
    unit = math.lcm(page, CHUNK)
    runs = max(1, -(-WAVES * SMS // max(1, B * KVH)))
    shortest = -(-MIN_SPLIT // unit) * unit
    return max(max_tokens // runs // unit * unit, shortest)


def head_chunks(group: int, Dh: int) -> int:
    """Blocks a KV head's ``group`` query heads are split over: the fewest
    equal chunks of at most ``MAX_GROUP_HEADS`` heads and
    ``MAX_GROUP_ELEMS`` accumulators (heads * Dh) each.  Each chunk's block
    reads its KV head's pages again, so more chunks are right and no faster.
    Granite-20b's 48 heads over one KV head at Dh 128 take 2 chunks of 24."""
    most = min(MAX_GROUP_HEADS, MAX_GROUP_ELEMS // Dh)
    return next(n for n in range(1, group + 1) if group % n == 0 and group // n <= most)


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"paged_attention: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"paged_attention: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"paged_attention: {name} must be a contiguous {ndim}-d tensor")
    if t.is_floating_point() and t.data_ptr() % 16:  # read in 16-byte vectors
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
    if Dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention: needs Dh in {HEAD_DIMS}, got Dh={Dh}")
    if B > 65535:
        raise ValueError("paged_attention: B must be at most 65535")
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    scale = scale if scale is not None else Dh**-0.5
    chunks = head_chunks(H // KVH, Dh)
    split = split_tokens(B, KVH * chunks, max_pages * page, page)
    n_split = -(-max_pages * page // split)
    # partial (acc, then m and l) of every (sequence, KV head, head chunk, run, head)
    part = (torch.empty(B * H * n_split * (Dh + 2), dtype=torch.float32, device=dev)
            if n_split > 1 else None)
    lib = _build.load()
    fn = lib.paged_attention_f32 if q.dtype == torch.float32 else lib.paged_attention_bf16
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        B, H, KVH, chunks, Dh, page, max_pages, P, split, n_split, float(scale), dev.index,
        _build.stream(dev),
    )
    _build.check("paged_attention", err)
    launches += 1
    return out
