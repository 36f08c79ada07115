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
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.binary_ip.ops import binary_ip
from repro_torch.kernels.binary_ip.ref import binary_ip_ref
from repro_torch.velo.batch_search import _prepare_queries
from repro_torch.velo.index import DeviceIndex

DEFAULT_CHUNK = 32768


def smallest(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest values of each row and their column indices, equal
    values in lower-index order (``jax.lax.top_k(-x, k)``'s selection)."""
    order = torch.argsort(x, dim=1, stable=True)[:, :k]
    return torch.gather(x, 1, order), order


def stage1_block(qunit: torch.Tensor, qnorm: torch.Tensor, codes_blk: torch.Tensor,
                 norms_blk: torch.Tensor, ipb_blk: torch.Tensor,
                 use_kernel: bool = True) -> torch.Tensor:
    """Level-1 estimates for one corpus block: -> (B, blk) bf16.  The sign
    product of the bf16 unit queries is ``binary_ip`` (the kernel on the
    card, its plain version on the CPU; ``use_kernel=False`` asks for the
    plain version everywhere)."""
    d = qunit.shape[1]
    qb16 = qunit.to(torch.bfloat16)
    g = binary_ip(qb16, codes_blk) if use_kernel else binary_ip_ref(qb16, codes_blk)
    g = (g / math.sqrt(d)).to(torch.bfloat16)
    ipb = torch.clamp_min(ipb_blk[None, :], 1e-6).to(torch.bfloat16)
    est_cos = torch.clamp(g / ipb, -1.0, 1.0)
    nr = norms_blk[None, :].to(torch.bfloat16)
    qn = qnorm.to(torch.bfloat16)
    return qn**2 + nr**2 - 2.0 * qn * nr * est_cos


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

    if n <= chunk:
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
            all_d = torch.cat([best_d, dc], dim=1)              # (B, 2C)
            all_i = torch.cat([best_i, bi * chunk + selc], dim=1)
            best_d, sel = smallest(all_d, C)
            best_i = torch.gather(all_i, 1, sel)
        if tail:
            est = block(nb * chunk, n)
            ids = nb * chunk + torch.arange(tail, device=dev)[None, :]
            all_d = torch.cat([best_d, est], dim=1)
            all_i = torch.cat([best_i, ids.expand(B, tail)], dim=1)
            best_d, sel = smallest(all_d, C)
            best_i = torch.gather(all_i, 1, sel)
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
