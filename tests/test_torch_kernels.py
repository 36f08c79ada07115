"""The port's binary_ip / int4_dist kernels against the JAX package.

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
        i4_kernel.int4_dist_cuda(*_t(q, ext, lo, step))
    assert (bip_kernel.launches, i4_kernel.launches) == (b0, i0)


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
    q, codes = _bip_inputs(2, 16, 64, seed=8)
    _, ext, lo, step = _i4_inputs(2, 16, 64, seed=9)
    qt, ct, et, lt, st = _t(q, codes, ext, lo, step, device=cuda)
    ids = torch.tensor([0, 16, -1, 3], device=cuda)
    for out in (binary_ip(qt, ct, ids), int4_dist2(qt, et, lt, st, ids)):
        bad = torch.isnan(out).cpu().numpy()
        assert bad[:, [1, 2]].all() and not bad[:, [0, 3]].any()
    with pytest.raises(ValueError):
        binary_ip(qt, ct.cpu(), None)


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
