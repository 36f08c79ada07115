"""RaBitQ-style two-level vector quantization (paper §3.3, "Compressed Vertex-Based Record").

The paper compresses each record with ExtRaBitQ [12, 13]:

  level 1 — a 1-bit-per-dimension binary code, kept RESIDENT in memory, used for
            fast approximate distances that steer the traversal;
  level 2 — a 4-bit-per-dimension extended code stored in the on-disk record,
            used for accurate refinement once the record is fetched.

We implement the practical core of RaBitQ faithfully:

  * center on the dataset centroid, apply a random orthonormal rotation P
    (distances are rotation-invariant, but sign patterns of rotated residuals
    become unbiased direction estimators);
  * level-1 code: sign bits of the rotated residual.  The RaBitQ estimator of
    the angle between query and data residual is
        <x_hat, q_hat>  ~=  <x_bar, q_hat> / <x_bar, x_hat>
    where x_bar = sign(resid)/sqrt(d) is the quantized unit vector and
    <x_bar, x_hat> is the per-record corrective factor stored at build time;
  * level-2 code: per-record uniform 4-bit scalar quantization of the rotated
    residual (the "extended" code of ExtRaBitQ), reconstructed at refine time.

The device plane re-implements both distance evaluations as CUDA kernels
(kernels/binary_ip, kernels/int4_dist); this module is their numpy oracle and
the host plane's implementation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _random_rotation(d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    q, r = np.linalg.qr(a)
    # Fix signs so the rotation is a deterministic function of the seed.
    q *= np.sign(np.diag(r))
    return q.astype(np.float32)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(n, d) {0,1} -> (n, d/8) uint8, little-endian within each byte."""
    n, d = bits.shape
    assert d % 8 == 0, "dimension must be a multiple of 8 for bit packing"
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def unpack_bits(packed: np.ndarray, d: int) -> np.ndarray:
    return np.unpackbits(packed, axis=1, count=d, bitorder="little")


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """(n, d) uint8 in [0,15] -> (n, d/2) uint8, low nibble = even dim."""
    n, d = codes.shape
    assert d % 2 == 0
    lo = codes[:, 0::2] & 0xF
    hi = codes[:, 1::2] & 0xF
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray, d: int) -> np.ndarray:
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    out = np.empty((packed.shape[0], d), dtype=np.uint8)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out


@dataclasses.dataclass
class QuantizedBase:
    """Build-time artifacts for the whole base set."""

    centroid: np.ndarray        # (d,)
    rotation: np.ndarray        # (d, d) orthonormal
    binary_codes: np.ndarray    # (n, d/8) uint8 — RESIDENT (level 1)
    norms: np.ndarray           # (n,) float32 — ||resid||, resident metadata
    ip_bar: np.ndarray          # (n,) float32 — <x_bar, x_hat>, resident metadata
    ext_codes: np.ndarray       # (n, d/2 or d) uint8 — on-disk (level 2)
    ext_lo: np.ndarray          # (n,) float32 — per-record quant range low
    ext_step: np.ndarray        # (n,) float32 — per-record quant step
    dim: int
    ext_bits: int = 4           # paper default 4; 8 supported (ExtRaBitQ is
                                # bit-budget-parametric)

    # ---- memory accounting (paper Table 3's "memory footprint" components) ----
    def resident_bytes(self) -> int:
        # The dense rotation matrix is an implementation convenience: production
        # RaBitQ uses a fast structured transform (randomized Hadamard, O(d)
        # parameters), so it is excluded from the footprint accounting.
        return (
            self.binary_codes.nbytes
            + self.norms.nbytes
            + self.ip_bar.nbytes
            + self.centroid.nbytes
        )

    def record_payload(self, i: int) -> bytes:
        """The level-2 part of the on-disk record for vertex i."""
        return (
            self.ext_codes[i].tobytes()
            + np.float32(self.ext_lo[i]).tobytes()
            + np.float32(self.ext_step[i]).tobytes()
        )

    def record_payload_nbytes(self) -> int:
        return self.ext_codes.shape[1] + 8

    def decode_ext(self, packed_rows: np.ndarray) -> np.ndarray:
        """(n, payload_cols) uint8 -> (n, d) float codes (no scaling applied)."""
        if self.ext_bits == 4:
            return unpack_nibbles(packed_rows, self.dim).astype(np.float32)
        return packed_rows.astype(np.float32)


class RabitQuantizer:
    """Fits the rotation and produces both code levels."""

    def __init__(self, dim: int, seed: int = 0, ext_bits: int = 4):
        assert ext_bits in (4, 8), "extended codes: 4 (paper default) or 8 bits"
        self.dim = dim
        self.seed = seed
        self.ext_bits = ext_bits
        self.levels = (1 << ext_bits) - 1

    def fit_encode(self, base: np.ndarray) -> QuantizedBase:
        n, d = base.shape
        assert d == self.dim
        centroid = base.mean(axis=0).astype(np.float32)
        rot = _random_rotation(d, self.seed)
        resid = (base - centroid) @ rot.T  # rotated residuals; L2 preserved

        norms = np.linalg.norm(resid, axis=1).astype(np.float32)
        safe = np.maximum(norms, 1e-12)
        unit = resid / safe[:, None]

        bits = (resid > 0).astype(np.uint8)
        binary_codes = pack_bits(bits)
        # <x_bar, x_hat> with x_bar = sign/sqrt(d): mean absolute coordinate * sqrt(d)
        ip_bar = (np.abs(unit).sum(axis=1) / np.sqrt(d)).astype(np.float32)

        # Extended code: per-record uniform quantizer over the full [min, max]
        # range.  (Percentile clipping was tried and measured NET HARMFUL here:
        # mixture data has heavy per-row tails, and clipped dims contribute
        # errors ~10x the rounding noise.  ExtRaBitQ's optimized per-vector scale would recover ~1.3x,
        # not the 2.5x a Gaussian napkin-model predicts.)
        lo = resid.min(axis=1).astype(np.float32)
        hi = resid.max(axis=1).astype(np.float32)
        step = ((hi - lo) / self.levels).astype(np.float32)
        step = np.maximum(step, 1e-12)
        codes = np.clip(
            np.rint((resid - lo[:, None]) / step[:, None]), 0, self.levels
        ).astype(np.uint8)
        ext_codes = pack_nibbles(codes) if self.ext_bits == 4 else codes

        return QuantizedBase(
            centroid=centroid,
            rotation=rot,
            binary_codes=binary_codes,
            norms=norms,
            ip_bar=ip_bar,
            ext_codes=ext_codes,
            ext_lo=lo,
            ext_step=step,
            dim=d,
            ext_bits=self.ext_bits,
        )

    # ------------------------------------------------------------------ query

    @staticmethod
    def prepare_query(qb: QuantizedBase, q: np.ndarray) -> "PreparedQuery":
        qr = (q - qb.centroid) @ qb.rotation.T
        qnorm = float(np.linalg.norm(qr))
        qunit = qr / max(qnorm, 1e-12)
        return PreparedQuery(
            qr=qr.astype(np.float32),
            qnorm=qnorm,
            qunit=qunit.astype(np.float32),
            q_orig=q.astype(np.float32),
        )

    @staticmethod
    def estimate_batch(
        qb: QuantizedBase,
        pq: "PreparedQuery",
        codes: np.ndarray,
        norms: np.ndarray,
        ip_bar: np.ndarray,
    ) -> np.ndarray:
        """Level-1 estimated squared distances over a packed code matrix.

        ``codes`` is (m, d/8) uint8 — rows of ``qb.binary_codes`` (or any
        matrix in the same format); ``norms``/``ip_bar`` are the matching
        per-row resident metadata.  This is the batch primitive the
        DistanceEngine backends share with the CUDA binary_ip kernel.
        """
        d = qb.dim
        bits = unpack_bits(codes, d).astype(np.float32)
        signs = 2.0 * bits - 1.0  # {-1, +1}
        g = (signs @ pq.qunit) / np.sqrt(d)  # <x_bar, q_hat>
        est_cos = g / np.maximum(ip_bar, 1e-6)
        est_cos = np.clip(est_cos, -1.0, 1.0)
        out = pq.qnorm**2 + norms**2 - 2.0 * pq.qnorm * norms * est_cos
        return out.astype(np.float32, copy=False)

    @staticmethod
    def estimate_dist2(
        qb: QuantizedBase, pq: "PreparedQuery", ids: np.ndarray
    ) -> np.ndarray:
        """Level-1 estimated squared distances for a set of vertex ids.

        This is the in-memory distance used to steer traversal (paper §3.1
        step iii: "estimates distances to its neighbors using their quantized
        vectors").
        """
        return RabitQuantizer.estimate_batch(
            qb, pq, qb.binary_codes[ids], qb.norms[ids], qb.ip_bar[ids]
        )

    @staticmethod
    def refine_dist2_from_payload(
        qb: QuantizedBase, pq: "PreparedQuery", payload: bytes
    ) -> float:
        """Level-2 refined squared distance from an on-disk record payload."""
        d = qb.dim
        ncode = d // 2 if qb.ext_bits == 4 else d
        codes = np.frombuffer(payload[:ncode], dtype=np.uint8)[None, :]
        lo = np.frombuffer(payload[ncode : ncode + 4], dtype=np.float32)[0]
        step = np.frombuffer(payload[ncode + 4 : ncode + 8], dtype=np.float32)[0]
        rec = qb.decode_ext(codes)[0] * step + lo
        diff = pq.qr - rec
        return float(diff @ diff)

    @staticmethod
    def refine_batch(
        qb: QuantizedBase,
        pq: "PreparedQuery",
        codes: np.ndarray,
        lo: np.ndarray,
        step: np.ndarray,
    ) -> np.ndarray:
        """Level-2 refinement over a packed extended-code matrix.

        ``codes`` is (m, d/2) uint8 nibble-packed (or (m, d) for ext_bits=8);
        ``lo``/``step`` are the matching per-row dequant parameters.  This is
        the batch primitive shared with the CUDA int4_dist kernel.
        """
        rec = qb.decode_ext(codes) * step[:, None] + lo[:, None]
        diff = pq.qr[None, :] - rec
        return (diff * diff).sum(axis=1).astype(np.float32, copy=False)

    @staticmethod
    def refine_dist2(
        qb: QuantizedBase, pq: "PreparedQuery", ids: np.ndarray
    ) -> np.ndarray:
        """Vectorized level-2 refinement straight from the arrays (device-plane path)."""
        return RabitQuantizer.refine_batch(
            qb, pq, qb.ext_codes[ids], qb.ext_lo[ids], qb.ext_step[ids]
        )


@dataclasses.dataclass
class PreparedQuery:
    qr: np.ndarray     # rotated, centered query (d,)
    qnorm: float
    qunit: np.ndarray  # qr / ||qr||
    q_orig: np.ndarray  # original query (d,) — for exact fp32 refinement paths


@dataclasses.dataclass
class ResidentView:
    """Register-once host view of an index's resident code tables.

    The distance plane registers each ``QuantizedBase`` exactly once
    (``DistanceEngine.register_index``) and serves every later id-based score
    request from this handle: contiguous aliases of the level-1 binary codes /
    norms / ip_bar and the level-2 extended codes / dequant params, so the
    per-hop hot path is a single fancy-index gather per table — no repeated
    per-call re-materialization of code matrices from payload bytes.  The
    device backends wrap the same arrays as device-resident tables (uploaded
    once, gathered on-device).
    """

    qb: "QuantizedBase"          # strong ref: pins id(qb) for the registry key
    binary_codes: np.ndarray     # (n, d/8) uint8, contiguous
    norms: np.ndarray            # (n,) float32
    ip_bar: np.ndarray           # (n,) float32
    ext_codes: np.ndarray        # (n, d/2 or d) uint8, contiguous
    ext_lo: np.ndarray           # (n,) float32
    ext_step: np.ndarray         # (n,) float32

    @classmethod
    def from_qb(cls, qb: "QuantizedBase") -> "ResidentView":
        return cls(
            qb=qb,
            binary_codes=np.ascontiguousarray(qb.binary_codes),
            norms=np.ascontiguousarray(qb.norms),
            ip_bar=np.ascontiguousarray(qb.ip_bar),
            ext_codes=np.ascontiguousarray(qb.ext_codes),
            ext_lo=np.ascontiguousarray(qb.ext_lo),
            ext_step=np.ascontiguousarray(qb.ext_step),
        )

    def gather_level1(
        self, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.binary_codes[ids], self.norms[ids], self.ip_bar[ids]

    def gather_level2(
        self, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.ext_codes[ids], self.ext_lo[ids], self.ext_step[ids]

    def nbytes(self) -> int:
        return (
            self.binary_codes.nbytes + self.norms.nbytes + self.ip_bar.nbytes
            + self.ext_codes.nbytes + self.ext_lo.nbytes + self.ext_step.nbytes
        )


@dataclasses.dataclass
class CacheSlotView:
    """Slot-indexed sibling of ``ResidentView``: the HBM record-cache tier's
    level-2 code arrays, addressed by CACHE SLOT rather than vertex id.

    Where ``ResidentView`` aliases an index's full build-time tables (gathered
    by vid), this view aliases a ``DeviceRecordCache``'s ``cache_ext`` /
    ``cache_lo`` / ``cache_step`` slot arrays — the records currently resident
    in the HBM tier.  A refine request whose vids map to slots gathers rows
    from here (``refine_slots``) instead of re-uploading payload bytes; the
    slot indirection is resolved on the host (record_map lookup) and only the
    small slot-index vector crosses to the kernel.
    """

    qb: "QuantizedBase"          # the index whose records fill the slots
    ext: np.ndarray              # (S, d/2 or d) uint8 — aliases cache_ext
    lo: np.ndarray               # (S,) float32 — aliases cache_lo
    step: np.ndarray             # (S,) float32 — aliases cache_step

    def gather(
        self, slots: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.ext[slots], self.lo[slots], self.step[slots]

    def nbytes(self) -> int:
        return self.ext.nbytes + self.lo.nbytes + self.step.nbytes
