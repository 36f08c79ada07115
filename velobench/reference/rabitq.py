"""RaBitQ's tables worked out again from the base vectors and the seed.

``encode`` is a frozen copy of the arithmetic of the port's host quantizer
(``RabitQuantizer.fit_encode``: a seeded orthonormal rotation from NumPy's
QR, float32 residuals, 1-bit signs with their norms and ``ip_bar``, and a
per-row uniform 4-bit code over ``[min, max]``), written in the same NumPy
expressions so that its codes are the same bits.  A reference with other
codes would judge the quantizer's rounding, not the search.
``int4_dist2`` is the refined distance those codes define, the distance the
engine and the scan return: ``|qr - (code * step + lo)|^2``, computed here
in float64 (the reference) or in a lower precision (the control).
``estimate_dist2`` is the 1-bit estimate that steers the engine's search:
``|q|^2 + |r|^2 - 2 |q| |r| clip(<signs, q / |q|> / sqrt(d) / ip_bar)``, in
float64, or with the sign product in TF32 and the rest in float32 (the
control of an engine that states float32).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Encoding:
    centroid: np.ndarray   # (d,) float32
    rotation: np.ndarray   # (d, d) float32
    signs: np.ndarray      # (n, d) bool: rotated residual > 0
    norms: np.ndarray      # (n,) float32
    ip_bar: np.ndarray     # (n,) float32
    codes: np.ndarray      # (n, d) uint8 in [0, 15]
    lo: np.ndarray         # (n,) float32
    step: np.ndarray       # (n,) float32

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codes.shape[1]


def rotation(d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    return q.astype(np.float32)


def encode(base: np.ndarray, seed: int, levels: int = 15) -> Encoding:
    n, d = base.shape
    centroid = base.mean(axis=0).astype(np.float32)
    rot = rotation(d, seed)
    resid = (base - centroid) @ rot.T
    norms = np.linalg.norm(resid, axis=1).astype(np.float32)
    unit = resid / np.maximum(norms, 1e-12)[:, None]
    ip_bar = (np.abs(unit).sum(axis=1) / np.sqrt(d)).astype(np.float32)
    del unit
    lo = resid.min(axis=1).astype(np.float32)
    hi = resid.max(axis=1).astype(np.float32)
    step = np.maximum(((hi - lo) / levels).astype(np.float32), 1e-12)
    codes = np.clip(np.rint((resid - lo[:, None]) / step[:, None]), 0, levels).astype(np.uint8)
    return Encoding(centroid=centroid, rotation=rot, signs=resid > 0, norms=norms,
                    ip_bar=ip_bar, codes=codes, lo=lo, step=step)


def rotate(enc: Encoding, queries: np.ndarray) -> np.ndarray:
    """Rotated, centred queries (m, d) in float64."""
    q = np.asarray(queries, dtype=np.float64)
    return (q - enc.centroid.astype(np.float64)) @ enc.rotation.astype(np.float64).T


class Tables:
    """An encoding's code tables as tensors on ``device``."""

    def __init__(self, enc: Encoding, device):
        self.codes = torch.from_numpy(enc.codes).to(device)
        self.lo = torch.from_numpy(enc.lo).to(device)
        self.step = torch.from_numpy(enc.step).to(device)


def int4_dist2(tables: Tables, qr: torch.Tensor, ids: torch.Tensor,
               dtype: torch.dtype = torch.float64, block: int = 8192) -> torch.Tensor:
    """(m, c) squared distances from each rotated query qr (m, d) to the
    decoded rows ``ids`` (m, c), every operation in ``dtype``."""
    out = torch.empty(ids.shape, dtype=dtype, device=qr.device)
    for s in range(0, ids.shape[0], block):
        i = ids[s:s + block]
        x = (tables.codes[i].to(dtype) * tables.step[i][..., None].to(dtype)
             + tables.lo[i][..., None].to(dtype))
        diff = qr[s:s + block, None, :].to(dtype) - x
        out[s:s + block] = (diff * diff).sum(-1)
    return out


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero), as a tensor core reads it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def estimate_dist2(enc: Encoding, qr: torch.Tensor, owner: torch.Tensor, ids: torch.Tensor,
                   control: bool = False, block: int = 1 << 16
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(estimate, scale), each (M,) float64 on the host: the 1-bit estimate
    of row ``ids[j]`` for the rotated query ``qr[owner[j]]`` (qr float64),
    and ``|q|^2 + |r|^2``, the size of the terms it is made of."""
    dev, d = qr.device, qr.shape[1]
    signs = torch.from_numpy(enc.signs).to(dev)
    norms = torch.from_numpy(enc.norms).to(dev, torch.float64)
    ip_bar = torch.from_numpy(enc.ip_bar).to(dev, torch.float64)
    qn = torch.linalg.vector_norm(qr, dim=1)
    unit = qr / torch.clamp_min(qn, 1e-12)[:, None]
    dt = torch.float32 if control else torch.float64
    if control:
        unit = _tf32(unit.to(torch.float32))
    est, scale = [], []
    for s in range(0, ids.shape[0], block):
        i, o = ids[s:s + block], owner[s:s + block]
        u = unit[o]
        g = torch.where(signs[i], u, -u).sum(1) / math.sqrt(d)
        cos = torch.clamp(g / torch.clamp_min(ip_bar[i].to(dt), 1e-6), -1.0, 1.0)
        q, r = qn[o].to(dt), norms[i].to(dt)
        est.append((q * q + r * r - 2.0 * q * r * cos).to(torch.float64).cpu())
        scale.append((qn[o] ** 2 + norms[i] ** 2).cpu())
    if not est:
        return np.zeros(0), np.zeros(0)
    return torch.cat(est).numpy(), torch.cat(scale).numpy()
