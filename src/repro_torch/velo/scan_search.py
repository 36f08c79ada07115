"""Two-stage compressed scan: binary tensor-core sweep -> int4 rerank.

On a CPU+SSD, graph traversal wins because it touches ~L of n records.  On a
card the economics flip: the level-1 codes of a few million vectors fit in
device memory (d/8 bytes each), and the tensor cores turn the full binary
scan into a dense product — no data-dependent gathers, no traversal
serialism.  This is the paper's level-1/level-2 hierarchy with the traversal
replaced by a scan.

Stage 1 STREAMS over corpus chunks keeping a running top-C per query:
materializing the full (B, n) estimate matrix would need B x n x 2 bytes,
while a chunk keeps the working set at B x chunk.  Each chunk is one
``binary_ip`` launch on bf16 unit queries (the tensor-core path from 8 192
rows at B >= 2), then the estimator in bf16, op by op, with the reference's
casts: the level-1 estimate is a steering value that the int4 rerank
corrects, so bf16's ~3 decimal digits lose nothing.
Stage 2 gathers the surviving top-C candidates and refines them with the
int4 codes.

bf16 estimates tie often (thousands of equal values in a row of a few
thousand), and the reference's ``jax.lax.top_k`` puts equal values in
lower-index order while ``torch.topk`` promises no order.  So every top-k
here is a stable ascending sort of the distances followed by a cut
(``smallest``): the candidate set, and the order in which the carry and a
chunk are concatenated, are exactly the reference's.

On the card, after each chunk's ``binary_ip`` launch, the estimator and the
running top-C are one ``scan_select`` launch that reads the product once
and writes only the new (B, C) carry, bit for bit the plain chain's
(``kernels/scan_select``); CPU tensors, and ``use_kernel=False``, take the
plain chain.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.binary_ip.ops import binary_ip
from repro_torch.kernels.binary_ip.ref import binary_ip_ref
from repro_torch.kernels.scan_select import kernel as select_kernel
from repro_torch.kernels.scan_select.ref import estimate, merge, smallest
from repro_torch.velo.batch_search import _prepare_queries
from repro_torch.velo.index import DeviceIndex

DEFAULT_CHUNK = 32768


def stage1_block(qunit: torch.Tensor, qnorm: torch.Tensor, codes_blk: torch.Tensor,
                 norms_blk: torch.Tensor, ipb_blk: torch.Tensor,
                 use_kernel: bool = True) -> torch.Tensor:
    """Level-1 estimates for one corpus block: -> (B, blk) bf16.  The sign
    product of the bf16 unit queries is ``binary_ip`` (the kernel on the
    card, its plain version on the CPU; ``use_kernel=False`` asks for the
    plain version everywhere)."""
    qb16 = qunit.to(torch.bfloat16)
    g = binary_ip(qb16, codes_blk) if use_kernel else binary_ip_ref(qb16, codes_blk)
    return estimate(g, qnorm, norms_blk, ipb_blk, qunit.shape[1])


def _stage1_card(index: DeviceIndex, qunit: torch.Tensor, qnorm: torch.Tensor, C: int,
                 chunk: int) -> torch.Tensor:
    """Stage 1 on the card: per chunk one ``binary_ip`` launch and one
    ``scan_select`` launch; -> the (B, C) candidate ids.  The first chunk's
    product is launched before the operand tables are made, so that the
    card works while the host enqueues them."""
    codes = index.binary_codes[:-1]
    n, d = codes.shape[0], qunit.shape[1]
    qb16 = qunit.to(torch.bfloat16)
    g = binary_ip(qb16, codes[:chunk])
    qtab, rtab, ipb = select_kernel.tables(qnorm, index.norms[:n], index.ip_bar[:n])
    if n <= chunk:
        return select_kernel.scan_select_cuda(g, qtab, rtab, ipb, d, C)[1]
    B = qunit.shape[0]
    # the carry starts at bf16(3e38) with ids 0, as the reference's
    carry = (torch.full((B, C), 3e38, dtype=torch.bfloat16, device=index.device),
             torch.zeros((B, C), dtype=torch.int64, device=index.device))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        if lo:
            g = binary_ip(qb16, codes[lo:hi])
        carry = select_kernel.scan_select_cuda(g, qtab, rtab[lo:hi], ipb[lo:hi], d, C, lo, carry)
    return carry[1]


def scan_search(
    index: DeviceIndex,
    queries: torch.Tensor,    # (B, d)
    k: int = 10,
    rerank: int = 64,         # candidates refined in stage 2 (C)
    use_kernel: bool = True,  # False: the plain binary_ip_ref product
    chunk: int = DEFAULT_CHUNK,
):
    """Returns (ids (B, k) int64, dist2 (B, k) f32), on the index's device."""
    dev = index.device
    queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    B, d = queries.shape
    qr, qnorm, qunit = _prepare_queries(index, queries)

    codes = index.binary_codes[:-1]  # drop sentinel row
    n = codes.shape[0]
    C = min(rerank, n)

    def block(lo: int, hi: int) -> torch.Tensor:
        return stage1_block(qunit, qnorm, codes[lo:hi], index.norms[lo:hi],
                            index.ip_bar[lo:hi], use_kernel)

    if use_kernel and codes.is_cuda and B > 0 and C > 0:
        cand = _stage1_card(index, qunit, qnorm, C, chunk)
    elif n <= chunk:
        _, cand = smallest(block(0, n), C)
    else:
        nb = n // chunk
        tail = n - nb * chunk
        # the carry starts at bf16(3e38) with ids 0, as the reference's
        best_d = torch.full((B, C), 3e38, dtype=torch.bfloat16, device=dev)
        best_i = torch.zeros((B, C), dtype=torch.int64, device=dev)
        for bi in range(nb):
            # top-C of the chunk first, then a 2C merge with the carry
            dc, selc = smallest(block(bi * chunk, (bi + 1) * chunk), C)
            best_d, best_i = merge(best_d, best_i, dc, bi * chunk + selc, C)
        if tail:
            ids = nb * chunk + torch.arange(tail, device=dev)[None, :]
            best_d, best_i = merge(best_d, best_i, block(nb * chunk, n), ids.expand(B, tail), C)
        cand = best_i

    # ---- stage 2: gather top-C, int4 refine
    packed = index.ext_codes[cand].to(torch.int32)          # (B, C, d/2)
    lo4 = (packed & 0xF).to(torch.float32)
    hi4 = ((packed >> 4) & 0xF).to(torch.float32)
    codes4 = torch.stack([lo4, hi4], dim=-1).reshape(B, C, d)
    x = codes4 * index.ext_step[cand][..., None] + index.ext_lo[cand][..., None]
    diff = qr[:, None, :] - x
    refined = torch.einsum("bcd,bcd->bc", diff, diff)       # (B, C)

    d2, sel = smallest(refined, min(k, C))
    return torch.gather(cand, 1, sel), d2
