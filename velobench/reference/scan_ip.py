"""The inner-product scan's answers, worked out again in plain PyTorch.

The semantics of ``configs/text2image-scan.json``: queries padded with zeros
from d to D; stage 1 ranks every row by the negated estimate of
``<q - c, o - c> + <c, o - c>``, RaBitQ's 1-bit estimate over the bf16 unit
query (the sign product summed exactly, then
``-(cr + qn * nr * est_cos)`` op by op in bf16), and keeps the ``rerank``
smallest with equal values in lower-row order; stage 2 ranks those
candidates by ``-(<q, c> + <qr, x> + cr)`` over the int4 codes.  Here stage
1 runs over the whole table at once, with no chunks and no merges, and the
sign product in float64; the rerank runs in float64.

``control=True`` computes the same in the precision below the one the
configuration states: the sign product over int8 queries (one scale a
query) where the configuration states bf16, and the rerank in bf16 where it
states float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from velobench.reference import exact, rabitq_ip


class ScanTables(rabitq_ip.Tables):
    """The encoding's tables on ``device``, with the signs as a float64
    (n, D) matrix of +-1."""

    def __init__(self, enc: rabitq_ip.Encoding, device):
        super().__init__(enc, device)
        self.centroid = torch.from_numpy(enc.centroid).to(device)
        self.rotation = torch.from_numpy(enc.rotation).to(device)
        self.signs = torch.from_numpy(enc.signs).to(device).to(torch.float64) * 2.0 - 1.0
        self.ip_bar = torch.from_numpy(enc.ip_bar).to(device)


def _stage1(t: ScanTables, qr: torch.Tensor, control: bool) -> torch.Tensor:
    D = qr.shape[1]
    qnorm = torch.linalg.vector_norm(qr, dim=1, keepdim=True)
    qb16 = (qr / torch.clamp_min(qnorm, 1e-12)).to(torch.bfloat16)
    if control:
        q = qb16.to(torch.float64)
        scale = q.abs().amax(1, keepdim=True).clamp_min(1e-30) / 127.0
        q8 = torch.round(q / scale).clamp(-127, 127)
        g = ((q8 @ t.signs.T) * scale).to(torch.float32)
    else:
        g = (qb16.to(torch.float64) @ t.signs.T).to(torch.float32)
    g = (g / math.sqrt(D)).to(torch.bfloat16)
    ipb = torch.clamp_min(t.ip_bar[None, :], 1e-6).to(torch.bfloat16)
    est_cos = torch.clamp(g / ipb, -1.0, 1.0)
    nr = t.norms[None, :].to(torch.bfloat16)
    qn = qnorm.to(torch.bfloat16)
    return -(t.cr[None, :].to(torch.bfloat16) + qn * nr * est_cos)


def scan(t: ScanTables, enc: rabitq_ip.Encoding, queries: np.ndarray, k: int, rerank: int,
         control: bool = False, block: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """(ids (B, k) int64, negated inner products (B, k) float64) of the
    queries (B, d), best first."""
    dev = t.codes.device
    dtype = torch.bfloat16 if control else torch.float64
    qr64, qc64 = rabitq_ip.prepare(enc, queries)
    D = t.rotation.shape[0]
    ids_out, s_out = [], []
    with exact.no_tf32():
        qs = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
        qs = torch.nn.functional.pad(qs, (0, D - qs.shape[1]))
        for s in range(0, qs.shape[0], block):
            # stage 1 from the float32 residuals, as the scan takes them
            qr = (qs[s:s + block] - t.centroid[None, :]) @ t.rotation.T
            est = _stage1(t, qr, control)
            cand = torch.argsort(est, dim=1, stable=True)[:, :min(rerank, t.codes.shape[0])]
            del est
            sc = rabitq_ip.score(t, torch.from_numpy(qr64[s:s + block]).to(dev),
                                 torch.from_numpy(qc64[s:s + block]).to(dev), cand, dtype=dtype)
            sel = torch.argsort(sc, dim=1, stable=True)[:, :k]
            ids_out.append(torch.gather(cand, 1, sel).cpu())
            s_out.append(torch.gather(sc, 1, sel).to(torch.float64).cpu())
    return torch.cat(ids_out).numpy(), torch.cat(s_out).numpy()
