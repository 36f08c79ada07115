"""RaBitQ's inner-product tables worked out again from the base vectors and
the seed.

``encode`` is a frozen copy of the arithmetic of the port's quantizer with
``metric="ip"`` (``RabitQuantizer(d, seed, metric="ip").fit_encode``),
written in the same NumPy expressions so that its codes are the same bits:
the per-row ``cr = <c, o - c>`` in float64 (in blocks of 2^16 rows) rounded
once to float32; the base and the centroid padded with zeros from d to D,
the next multiple of 32; a seeded D x D orthonormal rotation from NumPy's
QR; float32 rotated residuals, their signs, norms and ``ip_bar`` over D; and
a per-row uniform 4-bit code over [min, max].
``score`` is the refined score those codes define, the one the scan returns:
``-(<q, c> + <qr, x> + cr)`` with x the decoded residual, computed here in
float64 (the reference) or in a lower precision (the control).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 1 << 16


@dataclasses.dataclass
class Encoding:
    centroid: np.ndarray   # (D,) float32, zeros past d
    rotation: np.ndarray   # (D, D) float32
    signs: np.ndarray      # (n, D) bool: rotated residual > 0
    norms: np.ndarray      # (n,) float32 |o - c|
    ip_bar: np.ndarray     # (n,) float32
    codes: np.ndarray      # (n, D) uint8 in [0, 15]
    lo: np.ndarray         # (n,) float32
    step: np.ndarray       # (n,) float32
    cr: np.ndarray         # (n,) float32 <c, o - c>

    @property
    def dim(self) -> int:
        return self.codes.shape[1]


def padded(d: int) -> int:
    return -(-d // 32) * 32


def encode(base: np.ndarray, seed: int, levels: int = 15) -> Encoding:
    n, d = base.shape
    D = padded(d)
    centroid = base.mean(axis=0).astype(np.float32)
    c64 = centroid.astype(np.float64)
    cr = np.empty(n, dtype=np.float32)
    for s in range(0, n, BLOCK):
        cr[s:s + BLOCK] = (base[s:s + BLOCK].astype(np.float64) - c64) @ c64
    if D != d:
        base = np.concatenate([base, np.zeros((n, D - d), dtype=base.dtype)], axis=1)
        centroid = np.concatenate([centroid, np.zeros(D - d, dtype=np.float32)])
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((D, D)))
    q *= np.sign(np.diag(r))
    rot = q.astype(np.float32)
    resid = (base - centroid) @ rot.T
    norms = np.linalg.norm(resid, axis=1).astype(np.float32)
    unit = resid / np.maximum(norms, 1e-12)[:, None]
    ip_bar = (np.abs(unit).sum(axis=1) / np.sqrt(D)).astype(np.float32)
    del unit
    lo = resid.min(axis=1).astype(np.float32)
    hi = resid.max(axis=1).astype(np.float32)
    step = np.maximum(((hi - lo) / levels).astype(np.float32), 1e-12)
    codes = np.clip(np.rint((resid - lo[:, None]) / step[:, None]), 0, levels).astype(np.uint8)
    return Encoding(centroid=centroid, rotation=rot, signs=resid > 0, norms=norms,
                    ip_bar=ip_bar, codes=codes, lo=lo, step=step, cr=cr)


def prepare(enc: Encoding, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rotated residuals (q - c) R^T (m, D), <q, c> (m,)), in float64."""
    q = np.asarray(queries, dtype=np.float64)
    q = np.concatenate([q, np.zeros((len(q), enc.dim - q.shape[1]))], axis=1)
    c = enc.centroid.astype(np.float64)
    return (q - c) @ enc.rotation.astype(np.float64).T, q @ c


class Tables:
    """An encoding's level-2 tables and ``cr`` as tensors on ``device``."""

    def __init__(self, enc: Encoding, device):
        self.codes = torch.from_numpy(enc.codes).to(device)
        self.lo = torch.from_numpy(enc.lo).to(device)
        self.step = torch.from_numpy(enc.step).to(device)
        self.cr = torch.from_numpy(enc.cr).to(device)
        self.norms = torch.from_numpy(enc.norms).to(device)


def score(tables: Tables, qr: torch.Tensor, qc: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype = torch.float64, block: int = 8192) -> torch.Tensor:
    """(m, c) ``-((<q, c> + <qr, x>) + cr)`` of each query (qr (m, D), qc
    (m,)) and the decoded rows ``ids`` (m, c), every operation in ``dtype``."""
    out = torch.empty(ids.shape, dtype=dtype, device=qr.device)
    for s in range(0, ids.shape[0], block):
        i = ids[s:s + block]
        x = (tables.codes[i].to(dtype) * tables.step[i][..., None].to(dtype)
             + tables.lo[i][..., None].to(dtype))
        ip = (x * qr[s:s + block, None, :].to(dtype)).sum(-1)
        out[s:s + block] = -((qc[s:s + block, None].to(dtype) + ip) + tables.cr[i].to(dtype))
    return out
