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
float32, within one bf16 ulp (2^-7 of the value) in bfloat16.  The bf16
kernels multiply on the tensor cores with P split into two bf16 terms, the
fp32 kernel with every operand split into two TF32 terms (3xTF32); the CPU
emulations at the end of this file show why one term is not enough in
either, and pin the fp32 kernel's fragment mapping.
"""

import math

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
CARD_FLASH += [
    (1, 4, 2, 200, 330, 32, True, None),     # Dh 32, lengths off the 128-row tiles
    (1, 2, 1, 190, 300, 256, True, 100),     # Dh 256, window, off the 64-key tiles
]
CARD_PAGED = PAGED_SHAPES + [
    (8, 32, 4, 128, 1024, 16, 64),
    (3, 8, 1, 256, 64, 16, 20),
    (2, 16, 2, 64, 40, 4, 17),
    (2, 32, 4, 128, 600, 16, 300),           # ~19 runs of 256 tokens, permuted tables
]
# the reduced configs' attention (src/repro/configs/yi_6b.py: 4/2 heads,
# granite_20b.py: 4/1 heads, both Dh 16), prefill causal and windowed
REDUCED_FLASH = [
    (2, 4, 2, 200, 200, 16, True, None),
    (2, 4, 2, 150, 330, 16, True, 64),
    (1, 4, 1, 257, 257, 16, True, None),
    (1, 4, 1, 130, 130, 16, False, 40),
]
# their decode, and granite-20b's full decode (48 query heads over one KV
# head of Dh 128: 6 144 accumulators, two head chunks of 24) at B in {1, 8}
# x context in {512, 2048}, which crosses the split-context path
REDUCED_PAGED = [
    (4, 4, 2, 16, 64, 16, 12),
    (3, 4, 1, 16, 300, 16, 90),
]
GRANITE_PAGED = [
    (B, 48, 1, 128, B * ctx // 16, 16, ctx // 16) for B in (1, 8) for ctx in (512, 2048)
]
CARD_FLASH += REDUCED_FLASH
CARD_PAGED += REDUCED_PAGED + GRANITE_PAGED


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


# the fp32 kernel's edges: Dh 32 and 256 (its two key-tile sizes, 64 and
# 32), windows, and Sq / Skv off the 64-row query tile and both key tiles
CARD_FLASH_F32 = [
    (1, 4, 2, 77, 141, 32, True, 40),
    (2, 4, 4, 65, 33, 32, False, 20),
    (1, 2, 1, 97, 161, 256, True, 50),
    (1, 2, 2, 130, 99, 256, False, 60),
    (1, 4, 1, 33, 95, 256, True, None),
    (2, 2, 1, 129, 31, 32, True, None),     # Sq > Skv: leading rows see nothing
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,Dh,causal,window", CARD_FLASH_F32)
def test_flash_f32_kernel_edges_match_plain(B, H, KVH, Sq, Skv, Dh, causal, window, cuda):
    qt, kt, vt = _t(*_flash_inputs(B, H, KVH, Sq, Skv, Dh, seed=Sq * Skv + Dh), device=cuda)
    n0 = flash_kernel.launches
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert flash_kernel.launches == n0 + 1 and got.dtype == torch.float32
    want = attention_ref(qt, kt, vt, causal=causal, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **CARD_TOL[torch.float32])


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_mixes_empty_single_and_multi_run_contexts(dtype, cuda):
    """One batch whose contexts take no run, part of one run, one token,
    and many runs (the last ragged), so the combine sees every case."""
    B, H, KVH, Dh, page, max_pages = 5, 32, 4, 128, 16, 200
    q, kp, vp, bt, _ = _paged_inputs(B, H, KVH, Dh, B * max_pages, page, max_pages, seed=12,
                                     permute=True)
    split = paged_kernel.split_tokens(B, KVH, max_pages * page, page)
    cl = np.asarray([0, 1, split - 3, 3 * split + 5, max_pages * page], np.int32)
    assert max_pages * page > 3 * split  # several runs a sequence
    qt, kt, vt = _t(q, kp, vp, device=cuda, dtype=dtype)
    btt, clt = _t(bt, cl, device=cuda)
    got = paged_attention(qt, kt, vt, btt, clt)
    want = paged_attention_ref(qt, kt, vt, btt, clt)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **CARD_TOL[dtype])


@pytest.mark.cuda
def test_paged_kernel_refuses_head_dims_it_was_not_built_for(cuda):
    assert paged_kernel.HEAD_DIMS == flash_kernel.HEAD_DIMS == (16, 32, 64, 128, 256)
    n0 = paged_kernel.launches
    q, kp, vp, bt, cl = _paged_inputs(2, 4, 2, 48, 8, 8, 2, seed=1)  # Dh 48
    with pytest.raises(ValueError, match="Dh"):
        paged_attention(*_t(q, kp, vp, bt, cl, device=cuda))
    assert paged_kernel.launches == n0


# ------------------------------- the wrappers' argument rules (CPU)


@pytest.mark.parametrize("Dh", paged_kernel.HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8, 16, 24, 32, 48, 64, 96])
def test_head_chunks_are_the_fewest_equal_chunks_that_fit(group, Dh):
    """A KV head's query heads are split into the fewest equal chunks of at
    most MAX_GROUP_HEADS heads and MAX_GROUP_ELEMS accumulators; query head
    h lands in block (chunk) h // G' of its sequence, whose pages' KV head
    is that block's // chunks: the KV head h // group the reference reads."""
    n = paged_kernel.head_chunks(group, Dh)
    g = group // n
    assert group % n == 0 and g <= paged_kernel.MAX_GROUP_HEADS
    assert g * Dh <= paged_kernel.MAX_GROUP_ELEMS
    assert all(group % m or group // m > min(paged_kernel.MAX_GROUP_HEADS,
                                             paged_kernel.MAX_GROUP_ELEMS // Dh)
               for m in range(1, n))
    KVH = 3
    H = KVH * group
    assert [(h // g) // n for h in range(H)] == [h // group for h in range(H)]


def test_granite_and_reduced_configs_need_no_refusal():
    """The shapes the reference takes and the kernels used to refuse:
    Dh 16 (every reduced config) in both kernels, and granite-20b's group of
    48 over Dh 128 in the paged one (two chunks of 24 heads)."""
    assert 16 in flash_kernel.HEAD_DIMS and 16 in paged_kernel.HEAD_DIMS
    assert paged_kernel.head_chunks(48, 128) == 2
    assert paged_kernel.head_chunks(4, 16) == paged_kernel.head_chunks(2, 16) == 1
    # CPU tensors at those shapes go to the plain versions, never the kernel
    p0, f0 = paged_kernel.launches, flash_kernel.launches
    for args in (REDUCED_PAGED[1], GRANITE_PAGED[0]):
        q, kp, vp, bt, cl = _paged_inputs(*args, seed=3)
        out = paged_attention(*_t(q, kp, vp, bt, cl))
        assert out.shape == q.shape and torch.isfinite(out).all()
        with pytest.raises(ValueError, match="must be on"):
            paged_kernel.paged_attention_cuda(*_t(q, kp, vp, bt, cl))
    q, k, v = _flash_inputs(1, 4, 1, 40, 40, 16, seed=2)
    assert torch.isfinite(flash_attention(*_t(q, k, v))).all()
    with pytest.raises(ValueError, match="must be on"):
        flash_kernel.flash_attention_cuda(*_t(q, k, v))
    assert (paged_kernel.launches, flash_kernel.launches) == (p0, f0)


@pytest.mark.parametrize("B,H,KVH,Sq,Skv,Dh,causal,window", REDUCED_FLASH)
def test_flash_plain_matches_jax_at_the_reduced_configs(B, H, KVH, Sq, Skv, Dh, causal, window,
                                                        jref):
    q, k, v = _flash_inputs(B, H, KVH, Sq, Skv, Dh, seed=Sq + Skv)
    got = flash_attention(*_t(q, k, v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(jref["flash_ref"](q, k, v, causal=causal,
                                                                 window=window)), **F32)
    if Sq * Skv * H <= 150 * 330 * 4:  # the interpret-mode Pallas op at the smaller shapes
        np.testing.assert_allclose(
            got, np.asarray(jref["flash"](q, k, v, causal=causal, window=window)), **F32)


@pytest.mark.parametrize("B,H,KVH,Dh,P,page,max_pages", REDUCED_PAGED + GRANITE_PAGED[:1])
def test_paged_plain_matches_jax_at_the_reduced_and_granite_shapes(B, H, KVH, Dh, P, page,
                                                                   max_pages, jref):
    args = _paged_inputs(B, H, KVH, Dh, P, page, max_pages, seed=P + H)
    got = paged_attention(*_t(*args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref["paged_ref"](*args)), **F32)
    if H * max_pages <= 4 * 90:  # the interpret-mode Pallas op at the reduced shapes
        np.testing.assert_allclose(got, np.asarray(jref["paged"](*args)), **F32)


# ------------------------------- the kernels' arithmetic, emulated on the CPU


def _tiled_attention(q, k, v, causal, split_p, bk=128):
    """The bf16 flash kernel's arithmetic in plain torch: fp32 S = Q K^T per
    key tile, online softmax in fp32, O += P V with P either split into
    hi = bf16(p) and lo = bf16(p - hi) or rounded once to bf16; q, k, v
    are bf16 and every product accumulates in fp32, as on the tensor cores."""
    B, H, S, Dh = q.shape
    group = H // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale = Dh**-0.5
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, Dh)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk]) * scale
        if causal:
            s = s.masked_fill(torch.arange(k0, min(S, k0 + bk))[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        terms = [hi, (p - hi).bfloat16().float()] if split_p else [hi]
        o = o * alpha + sum(torch.einsum("bhqk,bhkd->bhqd", t, vf[:, :, k0:k0 + bk])
                            for t in terms)
        m = m_new
    return (o / l).bfloat16()


@pytest.mark.parametrize("H,KVH,Dh,causal", [(32, 4, 128, True), (12, 12, 64, False)],
                         ids=["yi-6b", "whisper-small"])
def test_split_p_is_what_keeps_the_tensor_core_product_within_one_ulp(H, KVH, Dh, causal):
    """Why the bf16 flash kernel multiplies V by two bf16 terms of P: at
    Yi-6B's and whisper-small's widths (S = 512) P rounded once to bf16
    misses the kernel-vs-plain bar of one bf16 ulp, and hi + lo meets it."""
    q, k, v = _t(*_flash_inputs(1, H, KVH, 512, 512, Dh, seed=Dh + H), dtype=torch.bfloat16)
    want = attention_ref(q, k, v, causal=causal).float()
    split = _tiled_attention(q, k, v, causal, split_p=True).float()
    single = _tiled_attention(q, k, v, causal, split_p=False).float()
    torch.testing.assert_close(split, want, **CARD_TOL[torch.bfloat16])
    assert not torch.allclose(single, want, **CARD_TOL[torch.bfloat16])


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("H,KVH,Dh,page", sorted({s[1:4] + (s[5],) for s in CARD_PAGED}))
def test_split_rule_covers_every_token_once(B, H, KVH, Dh, page):
    """split_tokens at every context 1..4096: runs are multiples of the page
    and of the chunk, no shorter than MIN_SPLIT, cover each token of the
    context exactly once, and give WAVES waves of blocks unless the runs are
    already the shortest allowed."""
    for ctx in range(1, 4097):
        max_pages = -(-ctx // page)
        max_tokens = max_pages * page
        split = paged_kernel.split_tokens(B, KVH, max_tokens, page)
        assert split % page == 0 and split % paged_kernel.CHUNK == 0
        assert split >= paged_kernel.MIN_SPLIT
        n_split = -(-max_tokens // split)
        # the kernel's runs: [i * split, min(ctx, (i + 1) * split)) for the i
        # whose run starts inside the context
        runs = [range(i * split, min(ctx, (i + 1) * split)) for i in range(n_split)
                if i * split < ctx]
        assert [t for r in runs for t in r] == list(range(ctx))
        shortest = -(-paged_kernel.MIN_SPLIT // math.lcm(page, paged_kernel.CHUNK)) * \
            math.lcm(page, paged_kernel.CHUNK)
        assert B * KVH * n_split >= paged_kernel.WAVES * paged_kernel.SMS or split == shortest


def _split_combine(q, kp, vp, bt, cl, split):
    """The paged kernel's split-and-combine arithmetic in plain fp32 torch:
    each run of ``split`` tokens keeps (m, l, acc) from m = -1e30, masked
    tokens add nothing, a run past the context is skipped, and the runs
    are combined as acc 2^(m - M) / (l 2^(m - M))."""
    B, H, Dh = q.shape
    _, page, KVH, _ = kp.shape
    group = H // KVH
    scale2 = Dh**-0.5 * math.log2(math.e)
    out = torch.zeros(B, H, Dh)
    for b in range(B):
        ctx = max(0, min(int(cl[b]), bt.shape[1] * page))
        pos = torch.arange(ctx)
        k = kp[bt[b, pos // page].long(), pos % page].float()  # (ctx, KVH, Dh)
        v = vp[bt[b, pos // page].long(), pos % page].float()
        parts = []
        for t0 in range(0, ctx, split):
            kk = k[t0:t0 + split].repeat_interleave(group, dim=1)  # (n, H, Dh)
            vv = v[t0:t0 + split].repeat_interleave(group, dim=1)
            s = torch.einsum("hd,nhd->hn", q[b].float(), kk) * scale2
            m = torch.maximum(torch.full((H,), -1e30), s.amax(-1))
            p = torch.exp2(s - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("hn,nhd->hd", p, vv)))
        if parts:
            ms = torch.stack([pt[0] for pt in parts])
            f = torch.exp2(ms - ms.amax(0))
            l = sum(fi * pt[1] for fi, pt in zip(f, parts))
            acc = sum(fi[:, None] * pt[2] for fi, pt in zip(f, parts))
            out[b] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("split", [32, 96, 256])
def test_split_and_combine_matches_the_plain_version(split):
    """Contexts of 0, 1, a ragged run and several runs, some runs empty
    (the table is longer than every context), held to the fp32 bar."""
    B, H, KVH, Dh, page, max_pages = 5, 8, 2, 32, 16, 40
    q, kp, vp, bt, _ = _paged_inputs(B, H, KVH, Dh, B * max_pages, page, max_pages, seed=split,
                                     permute=True)
    cl = np.asarray([0, 1, split - 7, 3 * split + 5, max_pages * page - 9], np.int32)
    args = _t(q, kp, vp, bt, cl)
    got = _split_combine(*args, split=split)
    want = paged_attention_ref(*args)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, **CARD_TOL[torch.float32])


# ------------------------------- the fp32 kernel's 3xTF32 products, emulated


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """einsum of TF32 operands, products exact and sums in fp32 as on the
    tensor cores: hi.hi alone, or lo.hi + hi.lo + hi.hi (3xTF32)."""
    ah, bh = _tf32(a), _tf32(b)
    if not three:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def _tf32_attention(q, k, v, causal, three, bk=32):
    """The fp32 kernel's arithmetic in plain torch: S = Q K^T and O += P V
    per key tile with TF32 operands, the online softmax in fp32."""
    B, H, S, Dh = q.shape
    group = H // k.shape[1]
    kf = k.repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, Dh)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = _tf32_product("bhqd,bhkd->bhqk", q, kf[:, :, k0:k0 + bk], three) * Dh**-0.5
        if causal:
            s = s.masked_fill(torch.arange(k0, min(S, k0 + bk))[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tf32_product("bhqk,bhkd->bhqd", p, vf[:, :, k0:k0 + bk], three)
        m = m_new
    return o / l


@pytest.mark.parametrize("H,KVH,S,Dh,causal", [(2, 1, 512, 128, True), (2, 2, 1500, 64, False),
                                              (2, 1, 512, 256, True)],
                         ids=["yi-6b", "whisper-small", "dh256"])
def test_three_tf32_terms_keep_the_fp32_product_within_the_bar(H, KVH, S, Dh, causal):
    """Why the fp32 flash kernel multiplies in 3xTF32: at Yi-6B's,
    whisper-small's and Dh 256 widths (two heads of each), one TF32 pass
    misses the fp32 kernel-vs-plain bar (rtol 1e-4, atol 1e-5) and three
    terms meet it."""
    q, k, v = _t(*_flash_inputs(1, H, KVH, S, S, Dh, seed=Dh + S))
    want = attention_ref(q, k, v, causal=causal)
    three = _tf32_attention(q, k, v, causal, three=True)
    one = _tf32_attention(q, k, v, causal, three=False)
    torch.testing.assert_close(three, want, **CARD_TOL[torch.float32])
    assert not torch.allclose(one, want, **CARD_TOL[torch.float32])


def _mma_m16n8k8(a_regs, b_regs):
    """mma.sync m16n8k8 from the registers of a warp's 32 lanes, lane
    (g, t) = (lane // 4, lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4],
    A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}; returns d = {D[g][2t],
    D[g][2t+1], D[g+8][2t], D[g+8][2t+1]} for each lane."""
    A = np.zeros((16, 8))
    Bm = np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_regs[lane]
        Bm[t, g], Bm[t + 4, g] = b_regs[lane]
    D = A @ Bm
    return [(D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def test_fp32_kernel_fragments_compute_qk_and_pv():
    """The fp32 kernel's register mapping, emulated for one warp, 16 rows,
    one 8-key slice and one 8-dim slice: S = Q K^T reads Q's A fragment
    and K's B fragment as the kernel indexes shared memory (each lane's two
    dims adjacent, the same permutation on both sides); P's A fragment
    is the S accumulator itself, column t read as key 2t and column t + 4
    as key 2t + 1, and V's B fragment is read in that key order, which
    gives P V exactly.  Reading V in natural order with the same P
    registers does not."""
    rng = np.random.default_rng(0)
    Q = rng.integers(-8, 8, (16, 8)).astype(float)   # rows x dims
    K = rng.integers(-8, 8, (8, 8)).astype(float)    # keys x dims
    V = rng.integers(-8, 8, (8, 8)).astype(float)    # keys x dims
    lanes = [divmod(lane, 4) for lane in range(32)]
    # S: fragment column t is dim 2t, column t + 4 dim 2t + 1 (one float2 a
    # lane): a = Q[g][2t], Q[g+8][2t], Q[g][2t+1], Q[g+8][2t+1];
    # b = K[g][2t], K[g][2t+1]
    s_regs = _mma_m16n8k8(
        [(Q[g, 2 * t], Q[g + 8, 2 * t], Q[g, 2 * t + 1], Q[g + 8, 2 * t + 1]) for g, t in lanes],
        [(K[g, 2 * t], K[g, 2 * t + 1]) for g, t in lanes])
    S = Q @ K.T
    for (g, t), d in zip(lanes, s_regs):
        assert d == (S[g, 2 * t], S[g, 2 * t + 1], S[g + 8, 2 * t], S[g + 8, 2 * t + 1])
    # P V: a = {c0, c2, c1, c3} of the S accumulator, b = V[2t][g], V[2t+1][g]
    P = S
    a_p = [(d[0], d[2], d[1], d[3]) for d in s_regs]
    o_regs = _mma_m16n8k8(a_p, [(V[2 * t, g], V[2 * t + 1, g]) for g, t in lanes])
    O = P @ V
    for (g, t), d in zip(lanes, o_regs):
        assert d == (O[g, 2 * t], O[g, 2 * t + 1], O[g + 8, 2 * t], O[g + 8, 2 * t + 1])
    wrong = _mma_m16n8k8(a_p, [(V[t, g], V[t + 4, g]) for g, t in lanes])
    assert wrong != o_regs
