"""The port's paged_attention / flash_attention against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX ops (Pallas in interpret mode) on the shape sweep of
tests/test_kernels.py and against the JAX refs.  The CUDA kernels run only
on a card: those cases carry the ``cuda`` marker and skip here.

Against the JAX package the tolerances are the bars of tests/test_kernels.py:
rtol/atol 2e-3 for float32 (fp32 sums in another order) and 5e-2 for
bfloat16 inputs (bf16 rounding of the output and, against an fp32 ref, of the
inputs).  A CUDA kernel and its plain version read the same inputs, compute
in fp32 and round the output once, so they are held tighter: within 1e-6 in
float32, within one bf16 ulp (2^-7 of the value) in bfloat16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

F32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=5e-2, atol=5e-2)
# a CUDA kernel against its plain version on the same inputs, by input dtype
CARD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}

# B, H, KVH, Sq, Skv, Dh, causal, window (tests/test_kernels.py's sweep)
FLASH_SHAPES = [
    (1, 4, 2, 128, 128, 64, True, None),
    (2, 4, 1, 64, 192, 32, True, None),     # GQA + cross lengths + padding
    (1, 2, 2, 100, 100, 64, True, 37),      # sliding window, ragged tiles
    (1, 2, 2, 96, 96, 64, False, None),     # bidirectional (whisper encoder)
    (1, 8, 8, 256, 256, 128, True, None),
    (1, 4, 4, 128, 384, 64, True, 128),     # window + long KV (gemma3 local)
]
# B, H, KVH, Dh, P, page, max_pages
PAGED_SHAPES = [
    (2, 4, 2, 64, 16, 16, 4),
    (3, 8, 8, 32, 32, 8, 6),
    (1, 4, 1, 128, 8, 32, 3),
    (4, 2, 2, 64, 64, 16, 8),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's attention ops and refs (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from repro.kernels.flash_attention import flash_attention as j_flash
    from repro.kernels.flash_attention.ref import attention_ref as j_flash_ref
    from repro.kernels.paged_attention import paged_attention as j_paged
    from repro.kernels.paged_attention.ref import paged_attention_ref as j_paged_ref

    return dict(flash=j_flash, flash_ref=j_flash_ref, paged=j_paged, paged_ref=j_paged_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flash_inputs(B, H, KVH, Sq, Skv, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, KVH, Skv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, KVH, Skv, Dh)).astype(np.float32)
    return q, k, v


def _paged_inputs(B, H, KVH, Dh, P, page, max_pages, seed, permute=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((P, page, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((P, page, KVH, Dh)).astype(np.float32)
    if permute:  # every sequence owns its pages, as a pool's block tables give
        bt = rng.permutation(P)[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    else:
        bt = rng.integers(0, P, (B, max_pages)).astype(np.int32)
    cl = rng.integers(1, max_pages * page + 1, (B,)).astype(np.int32)
    return q, kp, vp, bt, cl


def _t(*arrays, device="cpu", dtype=None):
    out = [torch.from_numpy(a).to(device) for a in arrays]
    return [t.to(dtype) if dtype is not None and t.is_floating_point() else t for t in out]


# ------------------------------------------------------ plain vs the JAX package


@pytest.mark.parametrize("B,H,KVH,Sq,Skv,Dh,causal,window", FLASH_SHAPES)
def test_flash_plain_matches_jax(B, H, KVH, Sq, Skv, Dh, causal, window, jref):
    q, k, v = _flash_inputs(B, H, KVH, Sq, Skv, Dh, seed=Sq * 7 + Skv)
    got = flash_attention(*_t(q, k, v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(jref["flash_ref"](q, k, v, causal=causal,
                                                                 window=window)), **F32)
    if Sq * Skv * H <= 128 * 192 * 4:  # the interpret-mode Pallas op at the small shapes
        np.testing.assert_allclose(
            got, np.asarray(jref["flash"](q, k, v, causal=causal, window=window)), **F32)


def test_flash_bf16_matches_jax(jref):
    import jax.numpy as jnp

    q, k, v = _flash_inputs(1, 2, 2, 128, 128, 64, seed=3)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(jref["flash"](jq, jk, jv, causal=True), np.float32), **BF16)
    np.testing.assert_allclose(got, np.asarray(jref["flash_ref"](q, k, v, causal=True)), **BF16)


@pytest.mark.parametrize("B,H,KVH,Dh,P,page,max_pages", PAGED_SHAPES)
def test_paged_plain_matches_jax(B, H, KVH, Dh, P, page, max_pages, jref):
    args = _paged_inputs(B, H, KVH, Dh, P, page, max_pages, seed=P + page)
    got = paged_attention(*_t(*args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref["paged"](*args)), **F32)
    np.testing.assert_allclose(got, np.asarray(jref["paged_ref"](*args)), **F32)


def test_paged_short_context_matches_jax(jref):
    """context_len smaller than one page: only valid slots contribute."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, 32)).astype(np.float32)
    kp = rng.standard_normal((4, 16, 2, 32)).astype(np.float32)
    vp = rng.standard_normal((4, 16, 2, 32)).astype(np.float32)
    bt = np.asarray([[2, 0]], np.int32)
    cl = np.asarray([3], np.int32)
    got = paged_attention(*_t(q, kp, vp, bt, cl)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref["paged"](q, kp, vp, bt, cl)), **F32)
    np.testing.assert_allclose(got, np.asarray(jref["paged_ref"](q, kp, vp, bt, cl)), **F32)


def test_paged_bf16_matches_jax(jref):
    import jax.numpy as jnp

    q, kp, vp, bt, cl = _paged_inputs(2, 8, 2, 64, 16, 16, 4, seed=9)
    got = paged_attention(*_t(q, kp, vp, dtype=torch.bfloat16), *_t(bt, cl))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jref["paged"](jq, jk, jv, bt, cl), np.float32), **BF16)


# ------------------------------------------------- what the port defines itself


def test_rows_that_see_no_key_give_zeros():
    """Unspecified in the reference (its Pallas kernels give a mean of V,
    its refs NaN): the port gives zeros, for a sequence with
    ``context_len == 0`` and for a causal row placed before every key."""
    q, kp, vp, bt, cl = _paged_inputs(3, 4, 2, 32, 12, 8, 4, seed=2)
    cl[1] = 0
    got = paged_attention(*_t(q, kp, vp, bt, cl))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.isfinite(got).all() and got[[0, 2]].abs().sum() > 0

    q, k, v = _flash_inputs(1, 2, 1, 40, 24, 32, seed=4)
    got = flash_attention(*_t(q, k, v), causal=True)  # rows 0..15 precede key 0
    assert torch.equal(got[:, :, :16], torch.zeros_like(got[:, :, :16]))
    want = attention_ref(*_t(np.ascontiguousarray(q[:, :, 16:]), k, v), causal=True)
    torch.testing.assert_close(got[:, :, 16:], want)


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches only on the card: CPU tensors handed to it raise
    before anything is built or counted."""
    p0, f0 = paged_kernel.launches, flash_kernel.launches
    with pytest.raises(ValueError):
        paged_kernel.paged_attention_cuda(*_t(*_paged_inputs(2, 4, 2, 32, 8, 8, 2, seed=1)))
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_cuda(*_t(*_flash_inputs(1, 2, 1, 16, 16, 32, seed=1)))
    assert (paged_kernel.launches, flash_kernel.launches) == (p0, f0)


# ----------------------------------------------- the CUDA kernels (card only)

# the widths chip_smoke.py runs: Yi-6B (32/4 heads, Dh 128), gemma3-1b local
# layers (4/1 heads, Dh 256, window 512), whisper-small's encoder (12/12
# heads, Dh 64, 1500 frames, bidirectional)
CARD_FLASH = FLASH_SHAPES + [
    (1, 32, 4, 512, 512, 128, True, None),
    (1, 4, 1, 1024, 1024, 256, True, 512),
    (1, 12, 12, 1500, 1500, 64, False, None),
    (2, 8, 2, 100, 260, 64, False, 70),
    (1, 4, 2, 70, 50, 32, True, None),       # causal, Sq > Skv: leading rows see nothing
]
CARD_PAGED = PAGED_SHAPES + [
    (8, 32, 4, 128, 1024, 16, 64),
    (3, 8, 1, 256, 64, 16, 20),
    (2, 16, 2, 64, 40, 4, 17),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,Dh,causal,window", CARD_FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(B, H, KVH, Sq, Skv, Dh, causal, window, dtype, cuda):
    qt, kt, vt = _t(*_flash_inputs(B, H, KVH, Sq, Skv, Dh, seed=Sq + Dh), device=cuda,
                    dtype=dtype)
    n0 = flash_kernel.launches
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert flash_kernel.launches == n0 + 1 and got.dtype == dtype
    want = attention_ref(qt, kt, vt, causal=causal, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,Dh,P,page,max_pages", CARD_PAGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain(B, H, KVH, Dh, P, page, max_pages, dtype, cuda):
    q, kp, vp, bt, cl = _paged_inputs(B, H, KVH, Dh, P, page, max_pages, seed=B * P,
                                      permute=B * max_pages <= P)
    cl[-1] = min(int(cl[-1]), page - 1) or 1  # one context shorter than a page
    qt, kt, vt = _t(q, kp, vp, device=cuda, dtype=dtype)
    btt, clt = _t(bt, cl, device=cuda)
    n0 = paged_kernel.launches
    got = paged_attention(qt, kt, vt, btt, clt)
    assert paged_kernel.launches == n0 + 1 and got.dtype == dtype
    want = paged_attention_ref(qt, kt, vt, btt, clt)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **CARD_TOL[dtype])


@pytest.mark.cuda
def test_kernels_give_zeros_where_no_key_is_seen(cuda):
    q, kp, vp, bt, cl = _paged_inputs(3, 8, 2, 64, 16, 16, 4, seed=6)
    cl[1] = 0
    got = paged_attention(*_t(q, kp, vp, bt, cl, device=cuda))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.isfinite(got).all()
    with pytest.raises(ValueError):  # a card query over host pages: no fallback
        paged_attention(*_t(q, device=cuda), *_t(kp, vp, bt, cl))
    q, k, v = _flash_inputs(1, 2, 1, 40, 24, 32, seed=4)
    got = flash_attention(*_t(q, k, v, device=cuda), causal=True)
    assert torch.equal(got[:, :, :16], torch.zeros_like(got[:, :, :16]))
