"""The on-card scan's answers, worked out again in plain PyTorch.

The semantics of ``configs/veloann-scan.json``: stage 1 estimates every row
by RaBitQ's 1-bit estimator over the bf16 unit query (the sign product
summed exactly, then the estimator op by op in bf16), keeps the ``rerank``
smallest estimates with equal values in lower-row order, and stage 2 ranks
those candidates by their refined int4 distance.  Here stage 1 runs over the
whole table at once, with no chunks and no merges, and the sign product in
float64; the rerank runs in float64.

``control=True`` computes the same in the precision below the one the
configuration states: the sign product over int8 queries (one scale a
query) where the configuration states bf16, and the rerank in bf16 where it
states float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from velobench.reference import exact, rabitq


class ScanTables(rabitq.Tables):
    """The encoding's tables on ``device``, with the signs as a float64
    (n, d) matrix of +-1."""

    def __init__(self, enc: rabitq.Encoding, device):
        super().__init__(enc, device)
        self.centroid = torch.from_numpy(enc.centroid).to(device)
        self.rotation = torch.from_numpy(enc.rotation).to(device)
        self.signs = torch.from_numpy(enc.signs).to(device).to(torch.float64) * 2.0 - 1.0
        self.norms = torch.from_numpy(enc.norms).to(device)
        self.ip_bar = torch.from_numpy(enc.ip_bar).to(device)


def _stage1(t: ScanTables, qr: torch.Tensor, control: bool) -> torch.Tensor:
    d = qr.shape[1]
    qnorm = torch.linalg.vector_norm(qr, dim=1, keepdim=True)
    qb16 = (qr / torch.clamp_min(qnorm, 1e-12)).to(torch.bfloat16)
    if control:
        q = qb16.to(torch.float64)
        scale = q.abs().amax(1, keepdim=True).clamp_min(1e-30) / 127.0
        q8 = torch.round(q / scale).clamp(-127, 127)
        g = ((q8 @ t.signs.T) * scale).to(torch.float32)
    else:
        g = (qb16.to(torch.float64) @ t.signs.T).to(torch.float32)
    g = (g / math.sqrt(d)).to(torch.bfloat16)
    ipb = torch.clamp_min(t.ip_bar[None, :], 1e-6).to(torch.bfloat16)
    est_cos = torch.clamp(g / ipb, -1.0, 1.0)
    nr = t.norms[None, :].to(torch.bfloat16)
    qn = qnorm.to(torch.bfloat16)
    return qn**2 + nr**2 - 2.0 * qn * nr * est_cos


def scan(t: ScanTables, queries: np.ndarray, k: int, rerank: int, control: bool = False,
         block: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """(ids (B, k) int64, dist2 (B, k) float64) of the queries (B, d)."""
    dev = t.codes.device
    dtype = torch.bfloat16 if control else torch.float64
    ids_out, d_out = [], []
    with exact.no_tf32():
        qs = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
        for s in range(0, qs.shape[0], block):
            qr = (qs[s:s + block] - t.centroid[None, :]) @ t.rotation.T
            est = _stage1(t, qr, control)
            cand = torch.argsort(est, dim=1, stable=True)[:, :min(rerank, t.codes.shape[0])]
            del est
            d2 = rabitq.int4_dist2(t, qr.to(torch.float64), cand, dtype=dtype)
            sel = torch.argsort(d2, dim=1, stable=True)[:, :k]
            ids_out.append(torch.gather(cand, 1, sel).cpu())
            d_out.append(torch.gather(d2, 1, sel).to(torch.float64).cpu())
    return torch.cat(ids_out).numpy(), torch.cat(d_out).numpy()
