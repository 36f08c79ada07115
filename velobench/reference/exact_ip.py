"""Exact top-k by inner product: the ground truth of ``recall_at_10`` in the
inner-product cells.

Float32 on ``device`` with TF32 off, in blocks of queries so that one
block's (queries x base) inner products fit."""

from __future__ import annotations

import numpy as np
import torch

from velobench.reference.exact import no_tf32


def topk(base: np.ndarray, queries: np.ndarray, k: int, device,
         block_bytes: int = 1 << 30) -> np.ndarray:
    """(q, k) int64 ids of the k base rows of largest inner product with
    each query, largest first."""
    with no_tf32():
        xb = torch.from_numpy(np.ascontiguousarray(base, dtype=np.float32)).to(device)
        qs = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(device)
        rows = max(1, block_bytes // (4 * xb.shape[0]))
        out = []
        for s in range(0, qs.shape[0], rows):
            ip = qs[s:s + rows] @ xb.T
            out.append(torch.topk(ip, k, dim=1, largest=True, sorted=True).indices.cpu())
    return torch.cat(out).numpy().astype(np.int64)
