"""Exact top-k under L2: the ground truth of ``recall_at_10``.

Float32 on ``device`` with TF32 off (a float32 product on the card would
otherwise run in TF32, a lower precision), in blocks of queries so that one
block's (queries x base) distances fit."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def topk(base: np.ndarray, queries: np.ndarray, k: int, device,
         block_bytes: int = 1 << 30) -> np.ndarray:
    """(q, k) int64 ids of the k nearest base rows of each query, nearest
    first."""
    with no_tf32():
        xb = torch.from_numpy(np.ascontiguousarray(base, dtype=np.float32)).to(device)
        xn = (xb * xb).sum(1)
        qs = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(device)
        rows = max(1, block_bytes // (4 * xb.shape[0]))
        out = []
        for s in range(0, qs.shape[0], rows):
            q = qs[s:s + rows]
            d2 = (q * q).sum(1, keepdim=True) + xn[None, :] - 2.0 * (q @ xb.T)
            out.append(torch.topk(d2, k, dim=1, largest=False, sorted=True).indices.cpu())
    return torch.cat(out).numpy().astype(np.int64)
