"""The port's model layers (repro_torch.models) against the JAX package's, on
the CPU, at small sizes.

Inputs are drawn with numpy from a seed and rounded to the case's dtype the
same way on both sides; weights come from the reference's ``init_*`` and
travel through ``convert.lm_params_from_reference``.  Prefill attention is
held against both the reference's pure-jnp ``chunked_attention`` and its
Pallas ``flash_attention`` op in interpret mode.

Tolerances, by dtype: float32 rtol 1e-4 / atol 1e-5 (fp32 sums in another
order); bfloat16 rtol / atol 2e-2 (one bf16 rounding of an output that the
two packages may round on either side of a rounding point, a few ulps after
a chain of ops).  The chunked forms against their own per-step recurrences
keep the reference's bars (tests/test_models.py): 2e-4, and 1e-3 for
mamba's decode.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import mamba as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro.models import rwkv as RR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ("float32", "bfloat16")
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(a: np.ndarray, dtype: str):
    """The same values on both sides, rounded to ``dtype`` once."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **TOL[dtype])


def _params(tree, dtype=None):
    """A reference parameter tree, cast to ``dtype`` (its float leaves), and
    its port counterpart."""
    if dtype is not None:
        tree = jax.tree.map(lambda a: a.astype(JNP[dtype]) if a.dtype == jnp.bfloat16 else a, tree)
    return tree, convert.lm_params_from_reference(jax.tree.map(np.asarray, tree), "cpu")


# ------------------------------------------------------- norms, rope, swiglu


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_rope_swiglu_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    xr, xp = _pair(x, dtype)
    _close(L.rmsnorm(xp, torch.from_numpy(g)), RL.rmsnorm(xr, jnp.asarray(g)), dtype, "rmsnorm")

    q = rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    qr, qp = _pair(q, dtype)
    for theta in (10_000.0, 5_000_000.0):
        _close(L.rope(qp, torch.from_numpy(pos)[:, None, :], theta),
               RL.rope(qr, jnp.asarray(pos)[:, None, :], theta), dtype, "rope")

    w = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in ((64, 96), (64, 96), (96, 64))]
    wr, wp = zip(*(_pair(a, dtype) for a in w))
    _close(L.swiglu(xp, *wp), RL.swiglu(xr, *wr), dtype, "swiglu")


# ---------------------------------------------------------------- attention

# B, H, KVH, Sq, Skv, Dh, causal, window, block
ATTN_CASES = [
    (2, 4, 2, 40, 40, 16, True, 0, 16),      # GQA, causal, block does not divide S
    (1, 4, 4, 64, 64, 32, True, 0, 512),     # one block
    (2, 4, 1, 48, 48, 16, True, 12, 16),     # sliding window, ragged last block
    (1, 4, 2, 24, 37, 16, False, 0, 16),     # non-causal cross, Sq != Skv
    (2, 8, 2, 16, 64, 32, True, 0, 24),      # causal, queries right-aligned to keys
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,Dh,causal,window,block", ATTN_CASES)
def test_chunked_attention_matches_reference_and_flash_op(B, H, KVH, Sq, Skv, Dh, causal,
                                                          window, block, dtype):
    rng = np.random.default_rng(Sq * Skv + Dh)
    qr, qp = _pair(rng.standard_normal((B, H, Sq, Dh)).astype(np.float32), dtype)
    kr, kp = _pair(rng.standard_normal((B, KVH, Skv, Dh)).astype(np.float32), dtype)
    vr, vp = _pair(rng.standard_normal((B, KVH, Skv, Dh)).astype(np.float32), dtype)
    got = L.chunked_attention(qp, kp, vp, causal=causal, window=window, block=block)
    assert got.dtype == TORCH[dtype] and got.shape == (B, H, Sq, Dh)
    want = RL.chunked_attention(qr, kr, vr, causal=causal, window=window, block=block)
    _close(got, want, dtype, "vs chunked_attention")
    flash = ref_flash(qr, kr, vr, causal=causal, window=window or None, interpret=True)
    _close(got, flash, dtype, "vs the Pallas flash op")


def test_chunked_attention_on_the_cpu_keeps_autograd():
    """The plain version is differentiable tensor ops (the card's kernel has
    no backward and raises instead: tests/test_torch_lm.py)."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.standard_normal((1, 2, 8, 16)), dtype=torch.float32, requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 1, 8, 16)), dtype=torch.float32)
    L.chunked_attention(q, k, k).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ctx_kind", ["scalar", "per-row"])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(ctx_kind, window, dtype):
    B, H, KVH, S, Dh = 3, 8, 2, 20, 16
    rng = np.random.default_rng(window + len(ctx_kind))
    qr, qp = _pair(rng.standard_normal((B, H, Dh)).astype(np.float32), dtype)
    kr, kp = _pair(rng.standard_normal((B, KVH, S, Dh)).astype(np.float32), dtype)
    vr, vp = _pair(rng.standard_normal((B, KVH, S, Dh)).astype(np.float32), dtype)
    if ctx_kind == "scalar":
        ctx_r, ctx_p = 13, 13
    else:
        lens = np.array([1, 11, 20], np.int32)
        ctx_r, ctx_p = jnp.asarray(lens), torch.from_numpy(lens)
    got = L.decode_attention(qp, kp, vp, ctx_p, window=window)
    _close(got, RL.decode_attention(qr, kr, vr, ctx_r, window=window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [8, 512])
def test_chunked_ce_loss_matches_reference(chunk, dtype):
    rng = np.random.default_rng(chunk)
    hr, hp = _pair(rng.standard_normal((2, 21, 32)).astype(np.float32), dtype)
    ur, up = _pair((rng.standard_normal((32, 50)) * 0.2).astype(np.float32), dtype)
    labels = rng.integers(0, 50, (2, 21)).astype(np.int32)
    labels[0, :5] = -100  # ignored positions
    got = L.chunked_ce_loss(hp, torch.from_numpy(labels), up, chunk=chunk)
    want = RL.chunked_ce_loss(hr, jnp.asarray(labels), ur, chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), **TOL["float32"])  # fp32 inside


def test_embed_and_init_linear():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    toks = torch.tensor([[5, 0], [2, 2]], dtype=torch.int32)
    assert torch.equal(L.embed(toks, table), table[toks.long()])
    gen = torch.Generator().manual_seed(0)
    w = L.init_linear(gen, (256, 64))
    assert w.dtype == torch.bfloat16 and w.shape == (256, 64)
    assert abs(float(w.float().std()) - 256**-0.5) < 0.01
    again = L.init_linear(torch.Generator().manual_seed(0), (256, 64))
    assert torch.equal(w, again)


# ---------------------------------------------------------------------- moe


def test_top_k_breaks_ties_by_lower_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5],
                  [0.0, 0.2, 0.1, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3, 5):
        vals, idx = MoE._top_k(torch.from_numpy(x), k)
        rvals, ridx = jax.lax.top_k(jnp.asarray(x), k)
        assert idx.tolist() == np.asarray(ridx).tolist()
        assert np.array_equal(vals.numpy(), np.asarray(rvals))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity_factor", [4.0, 1.25, 0.25])  # no drops .. most drop
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_matches_reference(capacity_factor, n_shared, dtype):
    T, d, F, E, k = 24, 16, 32, 4, 2
    ref_p, p = _params(RMoE.init_moe(jax.random.key(3), d, F, E, n_shared, jnp.bfloat16),
                       dtype)
    xr, xp = _pair(np.random.default_rng(4).standard_normal((T, d)).astype(np.float32), dtype)
    out, aux = MoE.moe_ffn(p, xp, k, capacity_factor)
    ref_out, ref_aux = RMoE.moe_ffn(ref_p, xr, top_k=k, capacity_factor=capacity_factor)
    assert out.dtype == TORCH[dtype]
    _close(out, ref_out, dtype, "out")
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL["float32"])  # fp32 router
    assert float(aux) > 0


def test_moe_ffn_routes_tied_experts_like_the_reference():
    """Duplicated router columns give exactly tied probabilities: the lower
    expert index wins, as in jax.lax.top_k, and the capacity order follows."""
    T, d, F, E, k = 16, 8, 8, 4, 2
    ref_p, _ = _params(RMoE.init_moe(jax.random.key(5), d, F, E, 0, jnp.float32))
    router = np.asarray(ref_p["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 0]
    ref_p = dict(ref_p, router=jnp.asarray(router))
    p = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref_p), "cpu")
    xr, xp = _pair(np.random.default_rng(6).standard_normal((T, d)).astype(np.float32),
                   "float32")
    for cf in (4.0, 0.5):
        out, _ = MoE.moe_ffn(p, xp, k, cf)
        ref_out, _ = RMoE.moe_ffn(ref_p, xr, top_k=k, capacity_factor=cf)
        _close(out, ref_out, "float32")


# -------------------------------------------------------------------- mamba

MAMBA = dict(D=32, di=64, N=8, dtr=4, K=4)


def _mamba(dtype):
    c = MAMBA
    return _params(RM.init_mamba(jax.random.key(2), c["D"], c["di"], c["N"], c["dtr"], c["K"],
                                 jnp.bfloat16), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_seq_matches_reference(dtype):
    ref_p, p = _mamba(dtype)
    xr, xp = _pair((np.random.default_rng(9).standard_normal((2, 50, 32)) * 0.5)
                   .astype(np.float32), dtype)
    for chunk in (8, 32):
        _close(M.mamba_seq_chunked(p, xp, chunk=chunk),
               RM.mamba_seq_chunked(ref_p, xr, chunk=chunk), dtype, f"chunked {chunk}")
    _close(M.mamba_seq_recurrent(p, xp), RM.mamba_seq_recurrent(ref_p, xr), dtype, "recurrent")
    _close(M.mamba_seq(p, xp), RM.mamba_seq(ref_p, xr), dtype, "dispatch")


def test_mamba_chunked_matches_recurrence():
    _, p = _mamba("float32")
    x = torch.from_numpy((np.random.default_rng(10).standard_normal((2, 50, 32)) * 0.5)
                         .astype(np.float32))
    ref = M.mamba_seq_recurrent(p, x)
    for c in (8, 16, 64):
        np.testing.assert_allclose(M.mamba_seq_chunked(p, x, chunk=c).numpy(), ref.numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_seq_and_reference(dtype):
    ref_p, p = _mamba(dtype)
    c = MAMBA
    S = 10
    xr, xp = _pair((np.random.default_rng(11).standard_normal((2, S, c["D"])) * 0.5)
                   .astype(np.float32), dtype)
    state = M.init_mamba_state(2, c["di"], c["N"], c["K"], TORCH[dtype], "cpu")
    ref_state = RM.init_mamba_state(2, c["di"], c["N"], c["K"], JNP[dtype])
    outs = []
    for t in range(S):
        state, y = M.mamba_decode(p, state, xp[:, t])
        ref_state, ref_y = RM.mamba_decode(ref_p, ref_state, xr[:, t])
        _close(y, ref_y, dtype, f"step {t}")
        _close(state[1], ref_state[1], dtype, f"ssm state {t}")
        outs.append(y)
    if dtype == "float32":
        np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                                   M.mamba_seq_recurrent(p, xp).numpy(), rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------- rwkv

RWKV = dict(D=64, F=128, H=4)


def _rwkv(dtype, u_seed=None):
    c = RWKV
    ref_p = RR.init_rwkv(jax.random.key(0), c["D"], c["F"], c["H"], jnp.bfloat16)
    if u_seed is not None:  # a non-zero bonus exercises the diagonal term
        u = np.random.default_rng(u_seed).standard_normal((c["H"], c["D"] // c["H"])) * 0.3
        ref_p = dict(ref_p, u_bonus=jnp.asarray(u, jnp.float32))
    return _params(ref_p, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_seq_matches_reference(dtype):
    ref_p, p = _rwkv(dtype, u_seed=1)
    H = RWKV["H"]
    xr, xp = _pair((np.random.default_rng(12).standard_normal((2, 50, 64)) * 0.5)
                   .astype(np.float32), dtype)
    for chunk in (8, 64):
        _close(R.time_mix_seq_chunked(p, xp, H, chunk=chunk),
               RR.time_mix_seq_chunked(ref_p, xr, H, chunk=chunk), dtype, f"chunked {chunk}")
    _close(R.time_mix_seq_recurrent(p, xp, H), RR.time_mix_seq_recurrent(ref_p, xr, H), dtype,
           "recurrent")
    _close(R.channel_mix_seq(p, xp), RR.channel_mix_seq(ref_p, xr), dtype, "channel mix")


def test_rwkv_chunked_matches_recurrence():
    _, p = _rwkv("float32", u_seed=2)
    x = torch.from_numpy((np.random.default_rng(13).standard_normal((2, 50, 64)) * 0.5)
                         .astype(np.float32))
    ref = R.time_mix_seq_recurrent(p, x, RWKV["H"])
    for c in (8, 16, 64):
        np.testing.assert_allclose(R.time_mix_seq_chunked(p, x, RWKV["H"], chunk=c).numpy(),
                                   ref.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_decode_matches_seq_and_reference(dtype):
    ref_p, p = _rwkv(dtype)
    D, H, S = RWKV["D"], RWKV["H"], 12
    xr, xp = _pair((np.random.default_rng(14).standard_normal((1, S, D)) * 0.5)
                   .astype(np.float32), dtype)
    ts, wkv, cs = R.init_rwkv_state(1, D, H, "cpu")
    rts, rwkv, rcs = RR.init_rwkv_state(1, D, H)
    outs = []
    for t in range(S):
        ts, wkv, y = R.time_mix_decode(p, ts, wkv, xp[:, t], H)
        rts, rwkv, ry = RR.time_mix_decode(ref_p, rts, rwkv, xr[:, t], H)
        _close(y, ry, dtype, f"time mix {t}")
        _close(wkv, rwkv, dtype, f"wkv {t}")
        cs, c_out = R.channel_mix_decode(p, cs, xp[:, t])
        rcs, rc_out = RR.channel_mix_decode(ref_p, rcs, xr[:, t])
        _close(c_out, rc_out, dtype, f"channel mix {t}")
        outs.append(y)
    if dtype == "float32":
        np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                                   R.time_mix_seq_recurrent(p, xp, H).numpy(),
                                   rtol=1e-4, atol=1e-4)
