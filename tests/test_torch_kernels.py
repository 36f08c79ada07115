"""The port's binary_ip / int4_dist / scan_select kernels against the JAX
package and their plain versions.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX ops (Pallas in interpret mode) and the JAX refs on the
shape sweep of tests/test_kernels.py, plus d=960 and bf16 queries.  The
CUDA kernels themselves run only on a card: those cases carry the ``cuda``
marker and skip here.

Tolerances: fp32 sums of up to d terms in another order than XLA's give
rtol 1e-5 / atol 1e-4 for the sign product and rtol 1e-4 / atol 1e-3 for
the int4 refine (the bars of tests/test_kernels.py); the host-quantizer
checks keep that file's rtol 2e-3 / atol 2e-3, since the NumPy estimator
mixes float64 into the epilogue.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import distance as distance_mod
from repro_torch.core.quant import RabitQuantizer
from repro_torch.kernels.binary_ip import binary_ip, estimate_dist2
from repro_torch.kernels.binary_ip import kernel as bip_kernel
from repro_torch.kernels.binary_ip.ref import binary_ip_ref, estimate_dist2_ref
from repro_torch.kernels.int4_dist import int4_dist2
from repro_torch.kernels.int4_dist import kernel as i4_kernel
from repro_torch.kernels.int4_dist.ref import int4_dist2_ref, unpack_nibbles
from repro_torch.kernels.scan_select import kernel as sel_kernel
from repro_torch.kernels.scan_select import ops as sel_ops
from repro_torch.kernels.scan_select import ref as sel_ref

BIP_SHAPES = [(1, 1, 8), (4, 10, 64), (128, 256, 128), (33, 777, 256),
              (5, 64, 1024), (8, 256, 960)]
I4_SHAPES = [(1, 1, 8), (3, 7, 64), (64, 200, 128), (16, 512, 960)]


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    old = distance_mod.default_device()
    distance_mod.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    distance_mod.set_default_device(old)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernel ops and refs (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from repro.kernels.binary_ip import binary_ip as j_bip
    from repro.kernels.binary_ip import estimate_dist2 as j_est
    from repro.kernels.binary_ip.ref import binary_ip_ref as j_bip_ref
    from repro.kernels.binary_ip.ref import estimate_dist2_ref as j_est_ref
    from repro.kernels.int4_dist import int4_dist2 as j_i4
    from repro.kernels.int4_dist.ref import int4_dist2_ref as j_i4_ref

    return dict(bip=j_bip, bip_ref=j_bip_ref, est=j_est, est_ref=j_est_ref,
                i4=j_i4, i4_ref=j_i4_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bip_inputs(B, N, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, d)).astype(np.float32)
    codes = rng.integers(0, 256, size=(N, d // 8)).astype(np.uint8)
    return q, codes


def _i4_inputs(B, N, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, d)).astype(np.float32)
    codes = rng.integers(0, 256, (N, d // 2)).astype(np.uint8)
    lo = rng.uniform(-2, -1, N).astype(np.float32)
    step = rng.uniform(0.1, 0.3, N).astype(np.float32)
    return q, codes, lo, step


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


# ------------------------------------------------------ plain vs the JAX package


@pytest.mark.parametrize("B,N,d", BIP_SHAPES)
def test_binary_ip_plain_matches_jax(B, N, d, jref):
    q, codes = _bip_inputs(B, N, d, seed=B * 1000 + N)
    got = binary_ip(*_t(q, codes)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref["bip"](q, codes)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref["bip_ref"](q, codes)),
                               rtol=1e-5, atol=1e-4)


def test_binary_ip_bf16_queries_match_jax(jref):
    """bf16 queries are widened to fp32 on both sides: the same rounded
    inputs, so the fp32 tolerance holds."""
    import jax.numpy as jnp

    q, codes = _bip_inputs(16, 64, 128, seed=11)
    q_t = torch.from_numpy(q).to(torch.bfloat16)
    got = binary_ip(q_t, torch.from_numpy(codes)).numpy()
    want = np.asarray(jref["bip"](jnp.asarray(q, jnp.bfloat16), codes))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,N,d", [(1, 64, 128), (8, 256, 128), (8, 256, 960)])
def test_estimate_dist2_plain_matches_jax(B, N, d, jref):
    rng = np.random.default_rng(d + N)
    q, codes = _bip_inputs(B, N, d, seed=d)
    norms = rng.uniform(0.5, 2.0, N).astype(np.float32)
    ip_bar = rng.uniform(0.6, 0.9, N).astype(np.float32)
    got = estimate_dist2(*_t(q, codes, norms, ip_bar)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref["est"](q, codes, norms, ip_bar)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jref["est_ref"](q, codes, norms, ip_bar)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,N,d", I4_SHAPES)
def test_int4_plain_matches_jax(B, N, d, jref):
    q, codes, lo, step = _i4_inputs(B, N, d, seed=B + N)
    got = int4_dist2(*_t(q, codes, lo, step)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref["i4"](q, codes, lo, step)),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jref["i4_ref"](q, codes, lo, step)),
                               rtol=1e-4, atol=1e-3)


def test_id_gather_equals_gathered_rows():
    """The id argument folds the gather into the kernel: on the CPU the
    result is bitwise the call on pre-gathered rows."""
    q, codes = _bip_inputs(4, 300, 64, seed=5)
    _, ext, lo, step = _i4_inputs(4, 300, 64, seed=6)
    ids = np.random.default_rng(7).integers(0, 300, 90)
    qt, ct, et, lt, st, it = _t(q, codes, ext, lo, step, ids)
    norms = torch.rand(300, generator=torch.Generator().manual_seed(0)) + 0.5
    ipb = torch.rand(300, generator=torch.Generator().manual_seed(1)) * 0.3 + 0.6
    assert torch.equal(binary_ip(qt, ct, it), binary_ip(qt, ct[it]))
    assert torch.equal(estimate_dist2(qt, ct, norms, ipb, it),
                       estimate_dist2(qt, ct[it], norms[it], ipb[it]))
    assert torch.equal(int4_dist2(qt, et, lt, st, it),
                       int4_dist2(qt, et[it], lt[it], st[it]))


def _int4_algebraic(q, codes, lo, step):
    """The CUDA int4_dist kernel's arithmetic in plain torch: no dequantised
    row, but <q, c step + lo> = step <q, c> + lo sum(q) and ||x||^2 =
    step^2 sum(c^2) + 2 step lo sum(c) + d lo^2, with c the nibbles."""
    d = q.shape[1]
    c = unpack_nibbles(codes, d)
    ip = step[None, :] * (q @ c.T) + lo[None, :] * q.sum(1, keepdim=True)
    xn = step**2 * (c * c).sum(1) + 2 * step * lo * c.sum(1) + d * lo**2
    return (q * q).sum(1, keepdim=True) - 2 * ip + xn[None, :]


@pytest.mark.parametrize("B,N,d", I4_SHAPES)
def test_int4_algebraic_dequant_matches_plain_and_jax(B, N, d, jref):
    q, codes, lo, step = _i4_inputs(B, N, d, seed=3 * B + N)
    got = _int4_algebraic(*_t(q, codes, lo, step)).numpy()
    np.testing.assert_allclose(got, int4_dist2_ref(*_t(q, codes, lo, step)).numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jref["i4"](q, codes, lo, step)),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jref["i4_ref"](q, codes, lo, step)),
                               rtol=1e-4, atol=1e-3)


def test_int4_algebraic_dequant_on_a_quantized_index(small_ds, small_qb, jref):
    """The same form on a RabitQuantizer index's level-2 codes, 8 rotated
    queries x 256 gathered ids, against the plain version and the JAX op."""
    qb = small_qb
    qr = ((small_ds.queries[:8] - qb.centroid) @ qb.rotation.T).astype(np.float32)
    ids = np.random.default_rng(3).integers(0, qb.ext_codes.shape[0], 256)
    args = (qr, qb.ext_codes[ids], qb.ext_lo[ids].astype(np.float32),
            qb.ext_step[ids].astype(np.float32))
    got = _int4_algebraic(*_t(*args)).numpy()
    np.testing.assert_allclose(got, int4_dist2_ref(*_t(*args)).numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jref["i4"](*args)), rtol=1e-4, atol=1e-3)


# ------------------- the binary_ip kernel's arithmetic, emulated on the CPU
# csrc/binary_ip.cu's tensor-core path multiplies bf16 terms of the query by
# +-1 signs on mma.sync.m16n8k16 in a permuted dim order, and both of its
# paths take the product on the raw query and scale it once.  These tests
# hold that arithmetic, written in numpy, against the plain version and the
# JAX package.


def _bf16_terms(x: np.ndarray, terms: int) -> list[np.ndarray]:
    """x (float32) as ``terms`` bf16 values, held in float32: x1 = bf16(x),
    x2 = bf16(x - x1), ... (round to nearest even, as __floats2bfloat162_rn)."""
    out, r = [], torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    for _ in range(terms):
        h = r.to(torch.bfloat16).to(torch.float32)
        out.append(h.numpy())
        r = r - h
    return out


def _signs(codes: np.ndarray, d: int) -> np.ndarray:
    return np.unpackbits(codes, axis=1, bitorder="little")[:, :d].astype(np.float32) * 2 - 1


def _tensor_core_sum(q: np.ndarray, codes: np.ndarray, terms: int) -> np.ndarray:
    """The tensor-core path's sums in float32: per 128 dims, the first
    term's products in one accumulator and the others' in a second, 16 dims
    (one k-step) at a time; the groups' two sums added to a float32 total."""
    d = q.shape[1]
    s = _signs(codes, d)
    parts = _bf16_terms(q, terms)
    tot = np.zeros((q.shape[0], codes.shape[0]), np.float32)
    for c0 in range(0, d, 128):
        hi, lo = np.zeros_like(tot), np.zeros_like(tot)
        for k0 in range(c0, min(c0 + 128, d), 16):
            k = slice(k0, k0 + 16)
            hi += parts[0][:, k] @ s[:, k].T
            for p in parts[1:]:
                lo += p[:, k] @ s[:, k].T
        tot += hi + lo
    return tot


_EDGE_VALUES = np.array(
    [0.0, -0.0, 1.0, -1.0, 1 - 2**-24, 1 + 2**-23, -(2 - 2**-23), 1 + 2**-8, 1 + 3 * 2**-8,
     2**-110, -(2 - 2**-23) * 2**-110, 3.38e38, -3.38e38, 1e-30, 7e30, np.pi], dtype=np.float32)


@pytest.mark.parametrize("d", [8, 128, 960])
def test_three_bf16_terms_reconstruct_fp32_queries(d):
    """q = q1 + q2 + q3 exactly (each term takes the next 8 significant bits
    of 24), from 2^-110 up to bf16's largest finite value; so the tensor
    cores' products of the terms with +-1 are exact and three terms summed
    in float32 meet the fp32 bar of the plain version.  One bf16 term (the
    query rounded to bf16) misses it: that is why fp32 queries take three."""
    rng = np.random.default_rng(d)
    wide = (rng.choice([-1.0, 1.0], 4096) * rng.uniform(1, 2, 4096)
            * 2.0 ** rng.integers(-110, 127, 4096)).astype(np.float32)
    for x in (wide, _EDGE_VALUES):
        t1, t2, t3 = _bf16_terms(x, 3)
        np.testing.assert_array_equal(t1.astype(np.float64) + t2 + t3, x.astype(np.float64))
        for t in (t1, t2, t3):  # each term is a bf16 value
            np.testing.assert_array_equal(t, _bf16_terms(t, 1)[0])
    q, codes = _bip_inputs(8, 300, d, seed=d + 1)
    want = binary_ip_ref(*_t(q, codes)).numpy()
    np.testing.assert_allclose(_tensor_core_sum(q, codes, 3), want, rtol=1e-5, atol=1e-4)
    assert not np.allclose(_tensor_core_sum(q, codes, 1), want, rtol=1e-5, atol=1e-4)


def _sign_pair(w: int, p: int) -> int:
    """csrc/binary_ip.cu's sign_pair: bits p and p + 16 of a code word as two
    bf16 signs (+1 where set), bit p in the low half, as 0xBF80BF80 - (w &
    bits) * 2^(15 - p) modulo 2^32."""
    return (0xBF80BF80 + (w & (0x00010001 << p)) * ((-(1 << (15 - p))) & 0xFFFFFFFF)) \
        & 0xFFFFFFFF


def _bf16_pair(u: int) -> tuple[float, float]:
    halves = np.array([(u & 0xFFFF) << 16, (u >> 16) << 16], dtype=np.uint32)
    lo, hi = halves.view(np.float32)
    return float(lo), float(hi)


def _pack_pair(lo: float, hi: float) -> int:
    """Two bf16-exact floats as one 32-bit register (lo in the low half)."""
    b = np.array([lo, hi], dtype=np.float32).view(np.uint32) >> 16
    return int(b[0]) | int(b[1]) << 16


def _fragments_product(q: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """The tensor-core path's data movement, lane by lane: lane (g, t) reads
    4-byte word t of rows g and g + 8 of a 16-row m-tile per 128 dims (a
    word past the row reads as 0), turns bits (2s, 2s + 16) and (2s + 1,
    2s + 17) into its A registers of k-step s, and takes Q's B registers 2s,
    2s + 1 from the layout the block writes (register r of lane (g, t) is
    the pair q_g[128c + 32t + r], q_g[128c + 32t + r + 16]).  The registers
    are placed where the PTX m16n8k16 fragment layout puts them and
    multiplied in float64.  q (<= 8, d) holds bf16-exact values; returns
    (B, N)."""
    B, d = q.shape
    N = codes.shape[0]
    words = codes.view("<u4").reshape(N, d // 32)
    groups = (d // 32 + 3) // 4
    qp = np.zeros((8, groups * 128), np.float32)
    qp[:B, :d] = q
    bfr = np.zeros((groups, 16, 32), dtype=np.int64)
    for c in range(groups):
        for r in range(16):
            for lane in range(32):
                g, t = divmod(lane, 4)
                k = 128 * c + 32 * t + r
                bfr[c, r, lane] = _pack_pair(qp[g, k], qp[g, k + 16])
    n_pad = -(-N // 16) * 16
    out = np.zeros((n_pad, 8))
    for m0 in range(0, n_pad, 16):
        for c in range(groups):
            for s in range(8):
                A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
                for lane in range(32):
                    g, t = divmod(lane, 4)

                    def word(row, c=c, t=t):
                        ok = row < N and 4 * c + t < words.shape[1]
                        return int(words[row, 4 * c + t]) if ok else 0

                    w0, w1 = word(m0 + g), word(m0 + g + 8)
                    A[g, 2 * t: 2 * t + 2] = _bf16_pair(_sign_pair(w0, 2 * s))
                    A[g + 8, 2 * t: 2 * t + 2] = _bf16_pair(_sign_pair(w1, 2 * s))
                    A[g, 2 * t + 8: 2 * t + 10] = _bf16_pair(_sign_pair(w0, 2 * s + 1))
                    A[g + 8, 2 * t + 8: 2 * t + 10] = _bf16_pair(_sign_pair(w1, 2 * s + 1))
                    Bm[2 * t: 2 * t + 2, g] = _bf16_pair(int(bfr[c, 2 * s, lane]))
                    Bm[2 * t + 8: 2 * t + 10, g] = _bf16_pair(int(bfr[c, 2 * s + 1, lane]))
                out[m0: m0 + 16] += A @ Bm
    return out[:N, :B].T


@pytest.mark.parametrize("B,N,d", [(8, 48, 128), (3, 20, 32), (5, 17, 960)])
def test_sign_fragment_order_computes_the_product(B, N, d):
    """The permuted dim order of the tensor-core path (signs and queries
    alike) reassembles into q @ signs.T exactly, with partial 128-dim groups
    (d = 32, 960), a ragged m-tile and fewer than 8 queries."""
    rng = np.random.default_rng(N + d)
    q = rng.integers(-64, 65, (B, d)).astype(np.float32) / 8  # bf16-exact
    codes = rng.integers(0, 256, (N, d // 8)).astype(np.uint8)
    want = q.astype(np.float64) @ _signs(codes, d).T.astype(np.float64)
    np.testing.assert_array_equal(_fragments_product(q, codes), want)


def _fused_estimate(q: np.ndarray, codes: np.ndarray, norms: np.ndarray,
                    ip_bar: np.ndarray) -> np.ndarray:
    """The kernel's estimate algebra in float32: the product on the raw
    query, scaled once by 1 / (max(||q||, 1e-12) sqrt(d)), the clamp and the
    clip as comparisons, then qn^2 + x^2 - 2 qn x cos."""
    d = q.shape[1]
    ip = q @ _signs(codes, d).T
    qn = np.sqrt((q * q).sum(axis=1, dtype=np.float32))[:, None]
    sc = np.float32(1) / (np.where(qn < 1e-12, np.float32(1e-12), qn) * np.float32(np.sqrt(d)))
    ibc = np.where(ip_bar < 1e-6, np.float32(1e-6), ip_bar)[None, :]
    c = (ip * sc) / ibc
    c = np.where(c < -1, np.float32(-1), np.where(c > 1, np.float32(1), c))
    return (qn * qn + norms[None, :] ** 2 - 2 * qn * norms[None, :] * c).astype(np.float32)


@pytest.mark.parametrize("B,N,d", [(8, 256, 128), (3, 31, 8), (8, 64, 960)])
def test_fused_estimator_algebra_matches_plain_and_jax(B, N, d, jref):
    """Including a zero query (the estimate is then x^2), rows whose ip_bar
    is below the 1e-6 clamp, and rows whose cosine estimate clips."""
    rng = np.random.default_rng(B * N + d)
    q, codes = _bip_inputs(B, N, d, seed=N + d)
    q[1] = 0.0
    norms = rng.uniform(0.5, 2.0, N).astype(np.float32)
    ip_bar = rng.uniform(0.6, 0.9, N).astype(np.float32)
    ip_bar[:3] = [0.0, 1e-9, 5e-7]
    ip_bar[3:6] = 1e-3
    got = _fused_estimate(q, codes, norms, ip_bar)
    np.testing.assert_allclose(got, estimate_dist2_ref(*_t(q, codes, norms, ip_bar)).numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref["est"](q, codes, norms, ip_bar)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref["est_ref"](q, codes, norms, ip_bar)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1], norms**2, rtol=1e-6)  # a zero query: x^2
    qn = np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    cos = (q / qn) @ _signs(codes, d).T / np.sqrt(d) / np.maximum(ip_bar, 1e-6)
    assert (np.abs(cos[[0, 2], :6]) > 1).sum() >= 10  # the clip acts


# ------------------------------- plain versions: each entry its own reduction


@pytest.mark.parametrize("d", [8, 64, 128, 960])
def test_plain_distances_are_bitwise_whatever_shares_the_call(d):
    """binary_ip_ref, estimate_dist2_ref and int4_dist2_ref give every
    (query, row) entry bit for bit whatever subset of queries and rows shares
    the call (the fused engine calls stack a schedule-dependent set of
    queries), and under a row-chunk small enough to split the call."""
    import repro_torch.kernels as kernels_pkg

    B, N = 9, 300
    rng = np.random.default_rng(d)
    q, codes = _bip_inputs(B, N, d, seed=d)
    _, ext, lo, step = _i4_inputs(B, N, d, seed=d + 1)
    norms = rng.uniform(0.5, 2.0, N).astype(np.float32)
    ip_bar = rng.uniform(0.6, 0.9, N).astype(np.float32)
    q, codes, ext, lo, step, norms, ip_bar = _t(q, codes, ext, lo, step, norms, ip_bar)
    full = (binary_ip_ref(q, codes), estimate_dist2_ref(q, codes, norms, ip_bar),
            int4_dist2_ref(q, ext, lo, step))
    old = kernels_pkg.PAIR_CHUNK_ELEMS
    try:
        for trial in range(24):
            if trial == 12:
                kernels_pkg.PAIR_CHUNK_ELEMS = 3 * d  # a few rows per chunk
            qi = np.sort(rng.choice(B, int(rng.integers(1, B + 1)), replace=False))
            ri = rng.choice(N, int(rng.integers(1, N + 1)), replace=False)
            qi_t, ri_t = torch.from_numpy(qi), torch.from_numpy(ri)
            sub = (binary_ip_ref(q[qi_t], codes[ri_t]),
                   estimate_dist2_ref(q[qi_t], codes[ri_t], norms[ri_t], ip_bar[ri_t]),
                   int4_dist2_ref(q[qi_t], ext[ri_t], lo[ri_t], step[ri_t]))
            for got, want in zip(sub, full):
                assert torch.equal(got, want[qi_t][:, ri_t]), (trial, qi, ri[:8])
    finally:
        kernels_pkg.PAIR_CHUNK_ELEMS = old


# ------------------------------------------------- plain vs the host quantizer


def test_estimate_matches_host_quantizer(small_ds, small_qb):
    """The kernel path must agree with the NumPy host-plane estimator — the
    two planes share one index format."""
    qb = small_qb
    q = small_ds.queries[:8]
    qr = ((q - qb.centroid) @ qb.rotation.T).astype(np.float32)
    dev = estimate_dist2(*_t(qr, qb.binary_codes, qb.norms, qb.ip_bar)).numpy()
    for i in range(8):
        pq = RabitQuantizer.prepare_query(qb, q[i])
        host = RabitQuantizer.estimate_dist2(qb, pq, np.arange(qb.norms.shape[0]))
        np.testing.assert_allclose(dev[i], host, rtol=2e-3, atol=2e-3)


def test_int4_matches_host_refine(small_ds, small_qb):
    qb = small_qb
    q = small_ds.queries[:4]
    qr = ((q - qb.centroid) @ qb.rotation.T).astype(np.float32)
    ids = np.arange(256)
    dev = int4_dist2(*_t(qr, qb.ext_codes[ids], qb.ext_lo[ids],
                         qb.ext_step[ids])).numpy()
    for i in range(4):
        pq = RabitQuantizer.prepare_query(qb, q[i])
        host = RabitQuantizer.refine_dist2(qb, pq, ids)
        np.testing.assert_allclose(dev[i], host, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------- the launch wrappers


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches only on the card: CPU tensors handed to it raise
    before anything is built or counted."""
    q, codes = _bip_inputs(2, 8, 64, seed=1)
    _, ext, lo, step = _i4_inputs(2, 8, 64, seed=2)
    b0, i0 = bip_kernel.launches, i4_kernel.launches
    with pytest.raises(ValueError):
        bip_kernel.binary_ip_cuda(*_t(q, codes))
    with pytest.raises(ValueError):
        bip_kernel.estimate_dist2_cuda(*_t(q, codes, lo, step))
    with pytest.raises(ValueError):
        i4_kernel.int4_dist_cuda(*_t(q, ext, lo, step))
    assert (bip_kernel.launches, i4_kernel.launches) == (b0, i0)


def test_scan_select_wrapper_refuses_what_it_does_not_take():
    """scan_select launches only on the card: CPU tensors, and a g that is
    not (B, L), raise before anything is built or counted."""
    g = torch.zeros(4, 40)
    qtab, rtab, ipb = sel_kernel.tables(torch.ones(4, 1), torch.ones(40), torch.ones(40) * 0.5)
    assert qtab.shape == (4, 2) and rtab.shape == (40, 2) and ipb.shape == (40,)
    assert rtab.dtype == torch.int32 and bool((rtab[:, 0].view(torch.float32) == 2.0).all())
    carry = (torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(4, 8, dtype=torch.int64))
    n0 = sel_kernel.launches
    for args in ((g, qtab, rtab, ipb, 64, 8), (g, qtab, rtab, ipb, 64, 8, 40, carry),
                 (g[0], qtab, rtab, ipb, 64, 8), (g.to(torch.float64), qtab, rtab, ipb, 64, 8)):
        with pytest.raises(ValueError):
            sel_kernel.scan_select_cuda(*args)
    assert sel_kernel.launches == n0


def test_scan_select_plain_is_the_scan_chain(small_ds, small_qb):
    """On the CPU ``scan_select`` is the plain chain that scan_search runs:
    chunk by chunk from the first carry it keeps the C smallest level-1
    estimates of the whole table by (value, row), which one stable sort of
    every estimate also picks."""
    from repro_torch.velo.scan_search import smallest, stage1_block

    n, d, C, L = small_qb.norms.shape[0], small_ds.dim, 48, 256
    q = torch.from_numpy(small_ds.queries[:9])
    rot, cen = torch.from_numpy(small_qb.rotation), torch.from_numpy(small_qb.centroid)
    qr = (q - cen[None, :]) @ rot.T
    qnorm = torch.linalg.vector_norm(qr, dim=1, keepdim=True)
    qunit = qr / torch.clamp_min(qnorm, 1e-12)
    codes, norms, ipb = (torch.from_numpy(a) for a in (small_qb.binary_codes, small_qb.norms,
                                                      small_qb.ip_bar))
    carry = (torch.full((9, C), 3e38, dtype=torch.bfloat16), torch.zeros((9, C), dtype=torch.int64))
    for lo in range(0, n, L):
        hi = min(lo + L, n)
        g = binary_ip(qunit.to(torch.bfloat16), codes[lo:hi])
        carry = sel_ops.scan_select(g, qnorm, norms[lo:hi], ipb[lo:hi], d, C, lo, carry)
    want_d, want_i = smallest(stage1_block(qunit, qnorm, codes, norms, ipb), C)
    assert torch.equal(carry[1], want_i)
    assert torch.equal(carry[0].view(torch.int16), want_d.view(torch.int16))


def test_tensor_core_path_rule():
    """Calls of two queries or more over TENSOR_CORE_MIN_ROWS rows or more
    take the tensor-core path where d % 32 == 0 and the codes are 4-byte
    aligned; asking for it where they are not raises."""
    big = bip_kernel.TENSOR_CORE_MIN_ROWS
    rule = bip_kernel.tensor_core_path
    assert rule(8, big, 128, 0) and rule(2, big, 960, 4096)
    assert not rule(8, big - 1, 128, 0) and not rule(1, 1_000_000, 128, 0)
    assert not rule(8, big, 8, 0) and not rule(8, big, 128, 2)
    assert rule(1, 1, 64, 0, True) and not rule(8, big, 128, 0, False)
    for d, ptr in ((8, 0), (128, 2)):
        with pytest.raises(ValueError):
            rule(8, 1, d, ptr, True)


# ----------------------------------------------- the CUDA kernels (card only)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d", BIP_SHAPES)
@pytest.mark.parametrize("gather", [False, True])
def test_binary_ip_kernel_matches_plain(B, N, d, gather, cuda):
    q, codes = _bip_inputs(B, N, d, seed=B + d)
    qt, ct = _t(q, codes, device=cuda)
    ids = None
    if gather:
        ids = torch.from_numpy(np.random.default_rng(d).integers(0, N, 3 * N + 1)).to(cuda)
    n0 = bip_kernel.launches
    got = binary_ip(qt, ct, ids)
    assert bip_kernel.launches == n0 + 1
    want = binary_ip_ref(qt, ct if ids is None else ct[ids])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_binary_ip_kernel_bf16_and_estimate(cuda):
    q, codes = _bip_inputs(8, 256, 960, seed=3)
    qt, ct = _t(q, codes, device=cuda)
    qb16 = qt.to(torch.bfloat16)
    np.testing.assert_allclose(
        binary_ip(qb16, ct).cpu().numpy(),
        binary_ip_ref(qb16, ct).cpu().numpy(), rtol=1e-5, atol=1e-4)
    rng = np.random.default_rng(4)
    norms, ipb = _t(rng.uniform(0.5, 2, 256).astype(np.float32),
                    rng.uniform(0.6, 0.9, 256).astype(np.float32), device=cuda)
    np.testing.assert_allclose(
        estimate_dist2(qt, ct, norms, ipb).cpu().numpy(),
        estimate_dist2_ref(qt, ct, norms, ipb).cpu().numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d", I4_SHAPES)
@pytest.mark.parametrize("gather", [False, True])
def test_int4_kernel_matches_plain(B, N, d, gather, cuda):
    q, codes, lo, step = _i4_inputs(B, N, d, seed=B * N)
    qt, ct, lt, st = _t(q, codes, lo, step, device=cuda)
    ids = None
    if gather:
        ids = torch.from_numpy(np.random.default_rng(N).integers(0, N, 2 * N + 3)).to(cuda)
    n0 = i4_kernel.launches
    got = int4_dist2(qt, ct, lt, st, ids)
    assert i4_kernel.launches == n0 + 1
    if ids is not None:
        ct, lt, st = ct[ids], lt[ids], st[ids]
    want = int4_dist2_ref(qt, ct, lt, st)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_kernels_flag_out_of_range_ids(cuda):
    """Both binary_ip entries on both paths, and int4_dist: an id outside
    the table gives NaN in its column and only there."""
    q, codes = _bip_inputs(2, 16, 64, seed=8)
    _, ext, lo, step = _i4_inputs(2, 16, 64, seed=9)
    qt, ct, et, lt, st = _t(q, codes, ext, lo, step, device=cuda)
    nt, ibt = lt + 3.0, st + 0.5  # norms and ip_bar, one per code row
    ids = torch.tensor([0, 16, -1, 3], device=cuda)
    for out in (binary_ip(qt, ct, ids), int4_dist2(qt, et, lt, st, ids),
                estimate_dist2(qt, ct, nt, ibt, ids),
                bip_kernel.binary_ip_cuda(qt, ct, ids, tensor_cores=True),
                bip_kernel.estimate_dist2_cuda(qt, ct, nt, ibt, ids, tensor_cores=True)):
        bad = torch.isnan(out).cpu().numpy()
        assert bad[:, [1, 2]].all() and not bad[:, [0, 3]].any()
    with pytest.raises(ValueError):
        binary_ip(qt, ct.cpu(), None)
    with pytest.raises(ValueError):
        estimate_dist2(qt, ct, nt.cpu(), ibt, ids)


# the search path's int4_dist edges: B around the kernel's query groups (1,
# 2-3, 8), N around its row groups, d from one 4-byte chunk a row to 30
# 16-byte chunks; ids into a SIFT1M-sized table or into an HBM slot mirror
I4_CARD_B, I4_CARD_N, I4_CARD_D = (1, 3, 8), (1, 7, 31, 33, 255, 257), (8, 64, 128, 960)
I4_TABLES = {"1M rows": 1_000_000, "hbm slots": 4096}


@pytest.fixture(scope="module")
def i4_tables():
    """Per (table, d): codes, lo, step made on the card from a seed, once."""
    made = {}

    def get(table, d, dev):
        if (table, d) not in made:
            T = I4_TABLES[table]
            gen = torch.Generator(device=dev).manual_seed(d)
            made[table, d] = (
                torch.randint(0, 256, (T, d // 2), generator=gen, device=dev, dtype=torch.uint8),
                torch.rand(T, generator=gen, device=dev) - 2.0,
                torch.rand(T, generator=gen, device=dev) * 0.2 + 0.1)
        return made[table, d]

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(I4_TABLES))
@pytest.mark.parametrize("d", I4_CARD_D)
@pytest.mark.parametrize("N", I4_CARD_N)
@pytest.mark.parametrize("B", I4_CARD_B)
def test_int4_kernel_edges_match_plain(B, N, d, table, cuda, i4_tables):
    ct, lt, st = i4_tables(table, d, cuda)
    rng = np.random.default_rng(B * N + d)
    qt = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, ct.shape[0], N)).to(cuda)
    n0 = i4_kernel.launches
    got = int4_dist2(qt, ct, lt, st, ids)
    assert i4_kernel.launches == n0 + 1 and got.shape == (B, N)
    want = int4_dist2_ref(qt, ct[ids], lt[ids], st[ids])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", I4_CARD_D)
def test_int4_kernel_flags_out_of_range_ids_at_every_width(d, cuda, i4_tables):
    ct, lt, st = i4_tables("hbm slots", d, cuda)
    T = ct.shape[0]
    qt = torch.from_numpy(np.random.default_rng(d).standard_normal((8, d)).astype(np.float32))
    ids = torch.tensor([0, T, -1, 3, T - 1, 1 << 40, 7], device=cuda)
    out = int4_dist2(qt.to(cuda), ct, lt, st, ids).cpu()
    bad = torch.isnan(out).numpy()
    assert bad[:, [1, 2, 5]].all() and not bad[:, [0, 3, 4, 6]].any()
    good = ids[[0, 3, 4, 6]]
    want = int4_dist2_ref(qt.to(cuda), ct[good], lt[good], st[good]).cpu()
    np.testing.assert_allclose(out[:, [0, 3, 4, 6]].numpy(), want.numpy(), rtol=1e-4, atol=1e-3)


# binary_ip's edges: B around the lanes path's query groups (1, 2-3, 8) and
# the tensor-core path's 8-query fragment, N around both paths' row groups,
# d from one byte a row to 120; ids into a SIFT1M-sized table, or none (the
# table's first N rows); fp32 and bf16 queries; each path
BIP_CARD_B, BIP_CARD_N, BIP_CARD_D = (1, 3, 8), (1, 7, 31, 33, 255, 257), (8, 64, 128, 960)
BIP_TABLE = 1_000_000


@pytest.fixture(scope="module")
def bip_tables():
    """Per d: codes, norms, ip_bar of BIP_TABLE rows made on the card from
    a seed, once (ip_bar in [0.05, 0.95], so that some cosines clip)."""
    made = {}

    def get(d, dev):
        if d not in made:
            gen = torch.Generator(device=dev).manual_seed(d)
            made[d] = (
                torch.randint(0, 256, (BIP_TABLE, d // 8), generator=gen, device=dev,
                              dtype=torch.uint8),
                torch.rand(BIP_TABLE, generator=gen, device=dev) * 2 + 0.25,
                torch.rand(BIP_TABLE, generator=gen, device=dev) * 0.9 + 0.05)
        return made[d]

    return get


def _bip_both_entries(qt, ct, nt, ibt, ids, tensor_cores):
    """Both entries on one path, against their plain versions on the rows
    they read; asserts one launch each."""
    n0 = bip_kernel.launches
    got_ip = bip_kernel.binary_ip_cuda(qt, ct, ids, tensor_cores=tensor_cores)
    got_est = bip_kernel.estimate_dist2_cuda(qt, ct, nt, ibt, ids, tensor_cores=tensor_cores)
    assert bip_kernel.launches == n0 + 2
    rows = (ct, nt, ibt) if ids is None else (ct[ids], nt[ids], ibt[ids])
    want_ip, want_est = binary_ip_ref(qt, rows[0]), estimate_dist2_ref(qt, *rows)
    np.testing.assert_allclose(got_ip.cpu().numpy(), want_ip.cpu().numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_est.cpu().numpy(), want_est.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["auto", "tensor cores"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table", ["1M rows", "no ids"])
@pytest.mark.parametrize("d", BIP_CARD_D)
@pytest.mark.parametrize("N", BIP_CARD_N)
@pytest.mark.parametrize("B", BIP_CARD_B)
def test_binary_ip_kernel_edges_match_plain(B, N, d, table, qdtype, path, cuda, bip_tables):
    ct, nt, ibt = bip_tables(d, cuda)
    rng = np.random.default_rng(B * N + d)
    qt = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(cuda)
    qt = qt.to(getattr(torch, qdtype))
    ids = None
    if table == "1M rows":
        ids = torch.from_numpy(rng.integers(0, BIP_TABLE, N)).to(cuda)
    else:
        ct, nt, ibt = ct[:N], nt[:N], ibt[:N]
    tc = None if path == "auto" else True
    if tc and d % 32:
        with pytest.raises(ValueError):
            bip_kernel.binary_ip_cuda(qt, ct, ids, tensor_cores=True)
        return
    _bip_both_entries(qt, ct, nt, ibt, ids, tc)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,d", [(8, BIP_TABLE, 128), (8, 200_000, 960), (33, 20_001, 128),
                                   (33, 300, 64)])
def test_binary_ip_kernel_sweeps_match_plain(B, N, d, qdtype, cuda, bip_tables):
    """Sweeps of the table (no ids) hold the fp32 bar over every row: on the
    tensor cores 8 queries x 1M rows at d = 128, x 200 000 at d = 960 (60
    k-steps a row), 33 queries (five blocks of 8) x 20 001 rows; on the
    lanes path 33 queries x 300 rows."""
    ct, nt, ibt = (t[:N] for t in bip_tables(d, cuda))
    assert bip_kernel.tensor_core_path(B, N, d, ct.data_ptr()) == (N >= 8192)
    rng = np.random.default_rng(d + B)
    qt = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(cuda)
    _bip_both_entries(qt.to(getattr(torch, qdtype)), ct, nt, ibt, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("d", BIP_CARD_D)
def test_binary_ip_kernel_flags_out_of_range_ids_at_every_width(d, cuda, bip_tables):
    ct, nt, ibt = bip_tables(d, cuda)
    T = ct.shape[0]
    qt = torch.from_numpy(np.random.default_rng(d).standard_normal((8, d)).astype(np.float32))
    ids = torch.tensor([0, T, -1, 3, T - 1, 1 << 40, 7], device=cuda)
    good = ids[[0, 3, 4, 6]]
    for tc in (False, True) if d % 32 == 0 else (False,):
        for out, want in (
                (bip_kernel.binary_ip_cuda(qt.to(cuda), ct, ids, tensor_cores=tc),
                 binary_ip_ref(qt.to(cuda), ct[good])),
                (bip_kernel.estimate_dist2_cuda(qt.to(cuda), ct, nt, ibt, ids, tensor_cores=tc),
                 estimate_dist2_ref(qt.to(cuda), ct[good], nt[good], ibt[good]))):
            out = out.cpu()
            bad = torch.isnan(out).numpy()
            assert bad[:, [1, 2, 5]].all() and not bad[:, [0, 3, 4, 6]].any()
            np.testing.assert_allclose(out[:, [0, 3, 4, 6]].numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_estimate_dist2_is_one_kernel(cuda, bip_tables):
    """On the card ops.estimate_dist2 runs exactly one CUDA kernel, the
    hand-written one: no PyTorch op before or after it (counted by the
    CUDA profiler at the search path's flush shape)."""
    from torch.profiler import ProfilerActivity, profile

    ct, nt, ibt = bip_tables(128, cuda)
    qt = torch.randn(8, 128, device=cuda)
    ids = torch.randint(0, BIP_TABLE, (256,), device=cuda)
    estimate_dist2(qt, ct, nt, ibt, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        estimate_dist2(qt, ct, nt, ibt, ids)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.self_device_time_total > 0 and not e.key.startswith(("Memcpy", "Memset"))}
    assert sum(kernels.values()) == 1 and "binary_lanes_kernel" in next(iter(kernels)), kernels


# scan_select: the card's carry against the plain chain's, bit for bit, after
# every chunk of a three-chunk scan from the first carry (so chunks two and
# three start from a carry of mid-scan), and without a carry where L >= C.
# The products g: binary_ip of unit queries over the test tables; rows of
# 1, 4 or 16 levels (with one norm and one ip_bar, every estimate of a level
# ties); estimates of exactly 0 and near it (and -0 put into the carry);
# NaN, inf and tiny products, and ip_bar of 2e38 and inf.
SEL_SOURCES = ("binary_ip", "levels 1", "levels 4", "levels 16", "zeros", "nan")
SEL_B, SEL_C, SEL_L = (1, 8, 64, 4096), (32, 64, 96), (32_768, 500, 333, 1)


def _select_inputs(source, B, L, dev, bip_tables):
    """(g (3, B, L) fp32, qnorm (B, 1), norms (3L,), ip_bar (3L,)), seeded."""
    d = 128
    gen = torch.Generator(device=dev).manual_seed(B * 7 + L)
    n = 3 * L
    if source in ("binary_ip", "nan"):
        codes, norms, ipb = (t[:n] for t in bip_tables(d, dev))
        q = torch.randn(B, d, generator=gen, device=dev)
        q = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).to(torch.bfloat16)
        g = torch.stack([binary_ip(q, codes[i * L:(i + 1) * L]) for i in range(3)])
        qnorm = torch.rand(B, 1, generator=gen, device=dev) * 1.5 + 0.5
        if source == "nan":  # and quotients that the kernel must take by IEEE division
            pick = torch.rand(g.shape, generator=gen, device=dev)
            g[pick < 0.05] = float("nan")
            g[(pick >= 0.05) & (pick < 0.06)] = float("inf")
            g[(pick >= 0.06) & (pick < 0.07)] = float("-inf")
            g[(pick >= 0.07) & (pick < 0.08)] = 3e-33
            ipb = ipb.clone()
            ipb[::7] = 2e38
            ipb[::11] = float("inf")
        return g, qnorm, norms, ipb
    ones = torch.ones(n, device=dev)
    if source == "zeros":  # cosines of 1 and beyond clip to an estimate of exactly 0
        levels = torch.tensor([1.0, 1.5, 0.99609375, 0.98, 1.0], device=dev)
        ipb = ones
    else:
        levels = torch.linspace(-0.6, 0.6, int(source.split()[1]), device=dev)
        ipb = ones * 0.8
    pick = torch.randint(0, len(levels), (3, B, L), generator=gen, device=dev)
    g = levels[pick] * float(np.sqrt(d))
    return g.contiguous(), torch.ones(B, 1, device=dev), ones, ipb


def _same_carry(got, want, where):
    assert torch.equal(got[1], want[1]), f"ids differ {where}"
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16)), \
        f"values differ {where}"


@pytest.mark.cuda
@pytest.mark.parametrize("L", SEL_L)
@pytest.mark.parametrize("C", SEL_C)
@pytest.mark.parametrize("B", SEL_B)
@pytest.mark.parametrize("source", SEL_SOURCES)
def test_scan_select_kernel_matches_plain(source, B, C, L, cuda, bip_tables):
    d = 128
    g, qnorm, norms, ipb = _select_inputs(source, B, L, cuda, bip_tables)
    qtab, rtab, ipt = sel_kernel.tables(qnorm, norms, ipb)
    n0 = sel_kernel.launches
    if L >= C:
        got = sel_kernel.scan_select_cuda(g[0], qtab, rtab[:L], ipt[:L], d, C)
        want = sel_ref.scan_select_ref(g[0], qnorm, norms[:L], ipb[:L], d, C)
        _same_carry(got, want, "without a carry")
    carry = (torch.full((B, C), 3e38, dtype=torch.bfloat16, device=cuda),
             torch.zeros((B, C), dtype=torch.int64, device=cuda))
    for i in range(3):
        lo = i * L
        got = sel_kernel.scan_select_cuda(g[i], qtab, rtab[lo:lo + L], ipt[lo:lo + L], d, C, lo,
                                          carry)
        want = sel_ref.scan_select_ref(g[i], qnorm, norms[lo:lo + L], ipb[lo:lo + L], d, C, lo,
                                       carry)
        _same_carry(got, want, f"after chunk {i}")
        carry = want
        if source == "zeros":  # -0 equals +0: flip every other zero of the carry to -0
            bits = carry[0].view(torch.int16).clone()
            flip = (bits == 0) & (torch.arange(C, device=cuda)[None, :] % 2 == 0)
            bits[flip] = -32768
            carry = (bits.view(torch.bfloat16), carry[1])
    assert sel_kernel.launches == n0 + 3 + (L >= C)


@pytest.mark.cuda
def test_scan_select_kernel_refuses_what_it_does_not_take(cuda):
    g = torch.zeros(4, 40, device=cuda)
    qtab, rtab, ipb = sel_kernel.tables(torch.ones(4, 1, device=cuda), torch.ones(40, device=cuda),
                                        torch.ones(40, device=cuda))
    carry = (torch.zeros(4, 8, dtype=torch.bfloat16, device=cuda),
             torch.zeros(4, 8, dtype=torch.int64, device=cuda))
    n0 = sel_kernel.launches
    for args in ((g, qtab, rtab, ipb, 64, 41), (g, qtab, rtab, ipb, 64, 0),
                 (g, qtab, rtab, ipb, 64, sel_kernel.MAX_C + 1, 0, carry),
                 (g, qtab, rtab[:39], ipb, 64, 8), (g, qtab, rtab, ipb[:39], 64, 8),
                 (g, qtab.float(), rtab, ipb, 64, 8), (g[:, ::2], qtab, rtab[:20], ipb[:20], 64, 8),
                 (g, qtab, rtab, ipb, 64, 9, 0, carry),
                 (g, qtab, rtab, ipb, 64, 8, (1 << 32) - 39, carry),
                 (g, qtab, rtab.cpu(), ipb, 64, 8)):
        with pytest.raises(ValueError):
            sel_kernel.scan_select_cuda(*args)
    assert sel_kernel.launches == n0


@pytest.mark.cuda
def test_scan_select_counts_full_selects(cuda, bip_tables):
    """The first chunk takes the full select in every row; later chunks of
    i.i.d. estimates keep their few survivors in the filter's buffer."""
    B, C, L, d = 64, 64, 32_768, 128
    g, qnorm, norms, ipb = _select_inputs("binary_ip", B, L, cuda, bip_tables)
    qtab, rtab, ipt = sel_kernel.tables(qnorm, norms, ipb)
    carry = (torch.full((B, C), 3e38, dtype=torch.bfloat16, device=cuda),
             torch.zeros((B, C), dtype=torch.int64, device=cuda))
    sel_kernel.reset_full_select_rows()
    carry = sel_kernel.scan_select_cuda(g[0], qtab, rtab[:L], ipt[:L], d, C, 0, carry)
    assert sel_kernel.full_select_rows() == B
    for i in (1, 2):
        rows = slice(i * L, (i + 1) * L)
        carry = sel_kernel.scan_select_cuda(g[i], qtab, rtab[rows], ipt[rows], d, C, i * L, carry)
    assert B <= sel_kernel.full_select_rows() <= B + 1


@pytest.fixture(scope="module")
def scan_index(small_qb):
    """The small quantized table as a velo DeviceIndex (an empty graph: a
    scan reads none), made on first use on the device asked for."""
    import types

    from repro_torch.velo import index as velo_index

    made = {}

    def get(dev):
        if dev not in made:
            empty = types.SimpleNamespace(
                adjacency=np.full((small_qb.norms.shape[0], 4), -1, np.int32), medoid=0)
            made[dev] = velo_index.from_host(small_qb, empty, device=dev)
        return made[dev]

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,rerank", [(32_768, 64), (500, 64), (512, 96), (256, 32)])
def test_scan_search_card_matches_plain_chain(chunk, rerank, cuda, small_ds, scan_index):
    """scan_search on the card (binary_ip and scan_select a chunk) returns
    the ids and distances of its plain chain (use_kernel=False) on the card,
    at the chunks of the CPU tests against the reference: one chunk,
    chunks, chunks and a tail."""
    from repro_torch.velo import scan_search as ss

    idx = scan_index(cuda)
    q = torch.from_numpy(small_ds.queries)
    n = idx.n
    n0 = sel_kernel.launches
    ids, d2 = ss.scan_search(idx, q, k=10, rerank=rerank, chunk=chunk)
    assert sel_kernel.launches == n0 + -(-n // chunk)
    want_ids, want_d2 = ss.scan_search(idx, q, k=10, rerank=rerank, chunk=chunk,
                                       use_kernel=False)
    assert torch.equal(ids, want_ids) and torch.equal(d2, want_d2)


@pytest.mark.cuda
def test_scan_search_stage1_runs_no_sort(cuda, small_ds, scan_index):
    """On the card stage 1 calls no library sort and no topk: a scan of six
    chunks runs as many sort kernels as stage 2's one stable sort of the
    (B, C) refined distances alone, six scan_select launches and six
    binary_ip launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.velo import scan_search as ss

    idx = scan_index(cuda)
    q = torch.from_numpy(small_ds.queries)
    B, C = q.shape[0], 64

    def kernels(fn):
        """The kernels of one call of fn; the profiler sometimes loses the
        records of a profiled run, so an empty reading is taken again."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            got = {e.key: e.count for e in prof.key_averages() if e.self_device_time_total > 0}
            if got:
                return got
        return got

    def sorts(ks):
        return sum(c for k, c in ks.items()
                   if any(p in k.lower() for p in ("sort", "fill_reverse", "fill_index", "topk")))

    scan = kernels(lambda: ss.scan_search(idx, q, k=10, rerank=C, chunk=256))
    alone = kernels(lambda: ss.smallest(torch.rand(B, C, device=cuda), 10))
    assert sorts(scan) == sorts(alone) > 0, (scan, alone)
    assert sum(c for k, c in scan.items() if "scan_select_kernel" in k) == 6, scan
    assert sum(c for k, c in scan.items()
               if "binary_lanes_kernel" in k or "binary_mma_kernel" in k) == 6, scan
