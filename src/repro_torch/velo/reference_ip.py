"""A plain reference of the inner-product scan, for holding ``scan_search``
over a ``RabitQuantizer(..., metric="ip")`` index against it on the CPU.

Plain ``torch`` and NumPy: nothing here imports a kernel of the port, the
port's quantizer or JAX, and every float32 product runs with TF32 off.  It
writes out again:

- ``encode``: the padded inner-product encoding, in the quantizer's own
  NumPy expressions (a reference with other codes would judge the rounding
  of the codes, not the search): the base and the centroid padded with
  zeros to D, the next multiple of 32; a seeded D x D orthonormal rotation
  from NumPy's QR; float32 rotated residuals; sign bits, norms, ``ip_bar``
  and a per-row uniform 4-bit code over [min, max]; and ``cr = <c, o - c>``
  in float64, rounded once to float32.
- ``stage1``: the level-1 rank of every row for every query at once, with
  no chunks and no merges: the sign product of the bf16 unit query in
  float64 (exact), then ``-(cr + qn * nr * est_cos)`` op by op in bf16.
- ``scan``: the ``rerank`` best ranks (equal values in lower-row order),
  rescored in float64 as ``-(<q, c> + <q - c, x> + cr)`` over the decoded
  int4 residuals x, and the k best of those.
- ``exact_topk``: the exact maximum-inner-product top-k, in float64.

Departures from the RaBitQ paper (Gao and Long, SIGMOD 2024), each the
port's: the rotation is a dense QR matrix, not a structured transform; the
query is not quantized (its unit vector is rounded to bf16, and the sign
product is exact); the estimator runs in bf16 and skips the paper's error
bound (the rerank of a fixed ``rerank`` candidates takes its place); the
level-2 code is a per-row uniform 4-bit code over [min, max], not
ExtRaBitQ's optimised scale; and inner product is served through the
centroid identity ``<q, o> = <q, c> + <q - c, o - c> + <c, o - c>``, with the
query's ``<q, c>`` left out of stage 1, where it orders nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch


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
    in_dim: int            # d


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def encode(base: np.ndarray, seed: int, levels: int = 15) -> Encoding:
    n, d = base.shape
    D = -(-d // 32) * 32
    centroid = base.mean(axis=0).astype(np.float32)
    c64 = centroid.astype(np.float64)
    cr = np.empty(n, dtype=np.float32)
    for s in range(0, n, 1 << 16):
        cr[s:s + (1 << 16)] = (base[s:s + (1 << 16)].astype(np.float64) - c64) @ c64
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
    lo = resid.min(axis=1).astype(np.float32)
    hi = resid.max(axis=1).astype(np.float32)
    step = np.maximum(((hi - lo) / levels).astype(np.float32), 1e-12)
    codes = np.clip(np.rint((resid - lo[:, None]) / step[:, None]), 0, levels).astype(np.uint8)
    return Encoding(centroid=centroid, rotation=rot, signs=resid > 0, norms=norms,
                    ip_bar=ip_bar, codes=codes, lo=lo, step=step, cr=cr, in_dim=d)


def prepare(enc: Encoding, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the rotated residuals (q - c) R^T (m, D), <q, c> (m,)), float64."""
    q = np.asarray(queries, dtype=np.float64)
    q = np.concatenate([q, np.zeros((len(q), enc.centroid.shape[0] - q.shape[1]))], axis=1)
    c = enc.centroid.astype(np.float64)
    return (q - c) @ enc.rotation.astype(np.float64).T, q @ c


def stage1(enc: Encoding, queries: np.ndarray) -> torch.Tensor:
    """(m, n) bf16 level-1 ranks of the rows, ascending best first.  The
    rotated residuals are taken in float32, as the scan takes them."""
    D = enc.centroid.shape[0]
    with no_tf32():
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
        q = torch.nn.functional.pad(q, (0, D - q.shape[1]))
        qr = (q - torch.from_numpy(enc.centroid)[None, :]) @ torch.from_numpy(enc.rotation).T
        qnorm = torch.linalg.vector_norm(qr, dim=1, keepdim=True)
        qb16 = (qr / torch.clamp_min(qnorm, 1e-12)).to(torch.bfloat16)
        signs = torch.from_numpy(enc.signs).to(torch.float64) * 2.0 - 1.0
        g = (qb16.to(torch.float64) @ signs.T).to(torch.float32)
    g = (g / math.sqrt(D)).to(torch.bfloat16)
    ipb = torch.clamp_min(torch.from_numpy(enc.ip_bar)[None, :], 1e-6).to(torch.bfloat16)
    est_cos = torch.clamp(g / ipb, -1.0, 1.0)
    nr = torch.from_numpy(enc.norms)[None, :].to(torch.bfloat16)
    qn = qnorm.to(torch.bfloat16)
    cr = torch.from_numpy(enc.cr)[None, :].to(torch.bfloat16)
    return -(cr + qn * nr * est_cos)


def refined(enc: Encoding, qr: np.ndarray, qc: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(m, c) float64 ``-(<q, c> + <qr, x> + cr)`` of the rows ``ids`` (m, c)."""
    x = (enc.codes[ids].astype(np.float64) * enc.step[ids][..., None].astype(np.float64)
         + enc.lo[ids][..., None].astype(np.float64))
    return -((qc[:, None] + np.einsum("mcd,md->mc", x, qr)) + enc.cr[ids].astype(np.float64))


def scan(enc: Encoding, queries: np.ndarray, k: int, rerank: int
         ) -> tuple[np.ndarray, np.ndarray]:
    """(ids (m, k) int64, negated inner products (m, k) float64), best first."""
    qr, qc = prepare(enc, queries)
    est = stage1(enc, queries)
    cand = torch.argsort(est, dim=1, stable=True)[:, :min(rerank, len(enc.norms))].numpy()
    score = refined(enc, qr, qc, cand)
    sel = np.argsort(score, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(cand, sel, 1), np.take_along_axis(score, sel, 1)


def exact_topk(base: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """(m, k) int64 ids of the k rows of largest inner product, largest first."""
    ip = np.asarray(queries, np.float64) @ np.asarray(base, np.float64).T
    return np.argsort(-ip, axis=1, kind="stable")[:, :k]
