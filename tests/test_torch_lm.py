"""The port's LM serving path (repro_torch.configs, repro_torch.models)
against the JAX package's, on the CPU, over the ten reduced architectures.

Both packages run the same weights: the reference's ``init_params`` in its
configs' bfloat16, carried over by ``convert.lm_params_from_reference``, and
cast to float32 for the float32 cases.  Each case runs ``prefill`` (logits
and caches), ``forward_train`` (the loss value), and four ``decode_step``s
from the prefill caches loaded into decode caches (logits each step, and the
caches after the last).

Tolerances.  float32: rtol 1e-4 / atol 1e-5.  bfloat16: a few elements of
a layer's output round to the other side of a bf16 rounding point in one
package (the matmuls sum in another order), and the random-weight stack
carries those ulps on, further with each layer.  So a bf16 output is held to
2e-2 of its largest magnitude (at least 1), or, where more, to twice the
largest distance between the reference's own bf16 and float32 runs over the
case's outputs of that kind (logits, caches, loss): two bf16 runs of one
float32 function (which the float32 cases show both packages compute), each
that far from it, are at most twice that apart.  Measured: the 2-layer
models 0.9-1.5 % of the logits' magnitude; gemma3's 8 layers up to 2.2 % of
a cache's (0.074 at 3.41).  jamba's 8 layers in bf16 are chaotic in the
reference itself (MoE routes and mamba's log-space decays move with bf16
ulps): its bf16 logits lie up to 3.95 from its float32 ones at magnitude
2.7, so there the bf16 case holds little beyond shapes, dtypes and finite
values, and its float32 case carries the comparison.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import layers as L
from repro_torch.models import model as PM

try:  # the reference: on the CPU host; the card's host has no JAX
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import model as RM
except ImportError:
    jax = None
needs_reference = pytest.mark.skipif(jax is None, reason="needs the JAX package")

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_SCALE = 2e-2
B, S, N_DECODE = 2, 20, 4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _leaves(tree, out=None):
    """Leaves in a fixed order (dict keys sorted), for either package."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _leaves(v, out)
    elif hasattr(tree, "shape"):
        out.append(tree)
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inject(pref, dec):
    """tests/test_models.py's injection of prefill caches into decode caches."""
    def leaf(pc, dc):
        if pc.shape == dc.shape:
            return pc.astype(dc.dtype)
        if (pc.ndim == dc.ndim and pc.shape[:-2] == dc.shape[:-2]
                and pc.shape[-1] == dc.shape[-1] and pc.shape[-2] <= dc.shape[-2]):
            return dc.at[..., : pc.shape[-2], :].set(pc.astype(dc.dtype))
        return dc
    return jax.tree.map(leaf, pref, dec, is_leaf=lambda x: hasattr(x, "shape"))


def _inputs(cfg):
    rng = np.random.default_rng(sum(map(ord, cfg.name)))
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab_size, (N_DECODE, B)).astype(np.int32)
    return batch, steps


def _lengths(cfg):
    """(prompt positions, decode cache slots, encoder slots)."""
    s_full = S + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    return s_full, s_full + N_DECODE, cfg.encoder_tokens if cfg.n_encoder_layers else 0


def _reference_run(arch, dtype):
    cfg = dataclasses.replace(ref_configs.get(arch, reduced=True), dtype=dtype)
    model = RM.build(cfg)
    params = RM.init_params(model, jax.random.key(0))  # bf16 where the config says
    params = jax.tree.map(lambda a: a.astype(jnp.float32) if dtype == "float32" else a, params)
    batch, steps = _inputs(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, caches = jax.jit(lambda p, b: RM.prefill(model, p, b))(params, jb)
    loss = jax.jit(lambda p, b: RM.forward_train(model, p, b))(params, jb)
    s_full, slots, enc = _lengths(cfg)
    dec = _inject(caches, RM.init_decode_caches(model, B, slots, enc_len=enc))
    step = jax.jit(lambda p, c, t, pos: RM.decode_step(model, p, c, t, pos))
    dec_logits = []
    for i in range(N_DECODE):
        out, dec = step(params, dec, jnp.asarray(steps[i]), jnp.int32(s_full + i))
        dec_logits.append(out)
    return dict(params=params, logits=logits, caches=_leaves(caches), loss=loss,
                dec_logits=dec_logits, dec_caches=_leaves(dec))


@pytest.fixture(scope="module")
def reference():
    """The reference's bf16 and float32 runs, per architecture, computed once."""
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = {d: _reference_run(arch, d) for d in ("bfloat16", "float32")}
        return runs[arch]
    return get


# ------------------------------------------------------------------- configs


@needs_reference
def test_registry_equals_the_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.ALIASES == ref_configs.ALIASES
    assert configs.all_archs() == ref_configs.all_archs()


@needs_reference
@pytest.mark.parametrize("name", list(configs.ALIASES))
def test_configs_equal_the_reference_field_for_field(name):
    for reduced in (False, True):
        mine, ref = configs.get(name, reduced=reduced), ref_configs.get(name, reduced=reduced)
        assert type(mine).__name__ == type(ref).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        if hasattr(ref, "params_count"):
            assert mine.params_count() == ref.params_count()
            assert mine.active_params_count() == ref.active_params_count()
            assert [mine.layer_kind(i) for i in range(mine.n_layers)] == \
                [ref.layer_kind(i) for i in range(ref.n_layers)]
            model, ref_model = PM.build(mine), RM.build(ref)
            assert (model.prefix_specs, model.group_specs, model.n_groups, model.n_enc_groups) \
                == tuple(_specs(ref_model))


def _specs(ref_model):
    from repro_torch.models.blocks import LayerSpec

    def conv(specs):
        return tuple(LayerSpec(**dataclasses.asdict(s)) for s in specs)
    return (conv(ref_model.prefix_specs), conv(ref_model.group_specs), ref_model.n_groups,
            ref_model.n_enc_groups)


@needs_reference
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's own init: the reference's tree, shapes and dtypes."""
    cfg = configs.get(arch, reduced=True)
    params = PM.init_params(PM.build(cfg), torch.Generator().manual_seed(0))
    specs = RM.params_specs(RM.build(ref_configs.get(arch, reduced=True)))
    mine, ref = _leaves(params), _leaves(specs)
    assert [tuple(t.shape) for t in mine] == [tuple(s.shape) for s in ref]
    assert [str(t.dtype)[6:] for t in mine] == [str(s.dtype) for s in ref]
    again = PM.init_params(PM.build(cfg), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(mine, _leaves(again)))


# -------------------------------------------------- the serving path vs JAX


def _spread(a, b) -> float:
    """Largest elementwise distance between two lists of arrays."""
    return max((float(np.abs(_np(x) - _np(y)).max()) for x, y in zip(a, b) if x.size),
               default=0.0)


def _check(got, want, dtype, spread=0.0, what=""):
    """float32: rtol / atol; bfloat16: 2e-2 of the largest magnitude (at
    least 1), or twice ``spread``, the reference's own bf16-to-float32
    distance for this kind of output, where that is more."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)
        return
    bar = max(BF16_SCALE * max(float(np.abs(want).max()), 1.0), 2 * spread)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= bar, f"{what}: max |port - reference| {err:.3e} > {bar:.3e}"


@needs_reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_prefill_decode_loss_match_the_reference(arch, dtype, reference):
    runs = reference(arch)
    ref = runs[dtype]
    spread = dict(logits=0.0, caches=0.0, loss=0.0)
    if dtype == "bfloat16":  # by kind: logits, caches, loss
        f32 = runs["float32"]
        spread = dict(
            logits=_spread([ref["logits"], *ref["dec_logits"]],
                           [f32["logits"], *f32["dec_logits"]]),
            caches=_spread(ref["caches"] + ref["dec_caches"], f32["caches"] + f32["dec_caches"]),
            loss=_spread([ref["loss"]], [f32["loss"]]))
    cfg = dataclasses.replace(configs.get(arch, reduced=True), dtype=dtype)
    model = PM.build(cfg)
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref["params"]), "cpu")
    batch, steps = _inputs(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    with torch.no_grad():
        logits, caches = PM.prefill(model, params, tb)
        loss = PM.forward_train(model, params, tb)
    _check(logits, ref["logits"], dtype, spread["logits"], "prefill logits")
    mine = _leaves(caches)
    assert len(mine) == len(ref["caches"])
    for i, (c, rc) in enumerate(zip(mine, ref["caches"])):
        assert str(c.dtype)[6:] == str(rc.dtype), f"prefill cache {i}"
        _check(c, rc, dtype, spread["caches"], f"prefill cache {i}")
    _check(loss, ref["loss"], dtype, spread["loss"], "loss")

    s_full, slots, enc = _lengths(cfg)
    dec = PM.load_prefill_caches(
        PM.init_decode_caches(model, B, slots, enc_len=enc, device="cpu"), caches)
    for i in range(N_DECODE):
        with torch.no_grad():
            out, dec = PM.decode_step(model, params, dec, torch.from_numpy(steps[i]), s_full + i)
        _check(out, ref["dec_logits"][i], dtype, spread["logits"], f"decode {i}")
    for i, (c, rc) in enumerate(zip(_leaves(dec), ref["dec_caches"])):
        _check(c, rc, dtype, spread["caches"], f"decode cache {i}")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-1b"])
def test_decode_continues_prefill(arch):
    """The port of tests/test_models.py's check, on the port's own weights:
    greedy decode from prefill caches == the forward over one more token
    (the configs' bf16, at that test's 3e-2)."""
    cfg = configs.get(arch, reduced=True)
    model = PM.build(cfg)
    params = PM.init_params(model, torch.Generator().manual_seed(0))
    Bsz, n = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (Bsz, n + 1)))
    with torch.no_grad():
        logits_full, _ = PM.prefill(model, params, {"tokens": toks})
        _, caches = PM.prefill(model, params, {"tokens": toks[:, :n]})
        dec = PM.load_prefill_caches(
            PM.init_decode_caches(model, Bsz, cache_len=n + 1, device="cpu"), caches)
        logits_dec, _ = PM.decode_step(model, params, dec, toks[:, n], n)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=3e-2, atol=3e-2)


def test_prefill_hands_decode_zero_recurrent_state():
    """The reference's handoff quirk, kept: mamba and rwkv layers return zero
    state from prefill, not the state their scan ended in."""
    for arch in ("jamba-v0.1-52b", "rwkv6-7b"):
        cfg = configs.get(arch, reduced=True)
        model = PM.build(cfg)
        params = PM.init_params(model, torch.Generator().manual_seed(1))
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)))
        with torch.no_grad():
            _, caches = PM.prefill(model, params, {"tokens": toks})
        for group in caches["groups"]:
            for name, t in group.items():
                if name in ("conv", "ssm", "tshift", "wkv", "cshift"):
                    assert not t.any(), (arch, name)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = PM.build(configs.get("yi-6b", reduced=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.init_decode_caches(model, 1, 8)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash_attention kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_on_the_card_has_the_plain_gradient(dtype, cuda):
    """With an input that requires a gradient, the card's chunked_attention
    launches the flash kernel once for its forward; its gradient equals
    autograd of the plain streaming recurrence on the same inputs, at the
    kernel-vs-plain attention bars (the backward is that recurrence; the
    forward's output feeds nothing back)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dt)
               for s in ((2, 4, 48, 16), (2, 2, 48, 16), (2, 2, 48, 16)))
    w = torch.randn((2, 4, 48, 16), generator=gen, device=cuda).to(dt)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-4)
    for window in (0, 16):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = flash_kernel.launches
        out = L.chunked_attention(*ins, window=window, block=16)
        assert flash_kernel.launches == before + 1
        grads = torch.autograd.grad((out.float() * w.float()).sum(), ins)
        assert flash_kernel.launches == before + 1  # the backward is plain
        plain_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = L._streaming_attention(*plain_ins, True, window, 16, None)
        want_grads = torch.autograd.grad((want.float() * w.float()).sum(), plain_ins)
        torch.testing.assert_close(out.float(), want.float(), **tol)
        for g, wg in zip(grads, want_grads):
            assert g.dtype == dt
            torch.testing.assert_close(g.float(), wg.float(), **tol)
    with torch.no_grad():
        out = L.chunked_attention(q.requires_grad_(True), k, v)  # no graph asked for
    assert out.grad_fn is None and flash_kernel.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_yi_prefill_on_the_card_launches_flash_per_layer(dtype, cuda):
    cfg = dataclasses.replace(configs.get("yi-6b", reduced=True), dtype=dtype)
    model = PM.build(cfg)
    params = PM.init_params(model, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 64)))
    with torch.no_grad():
        want, _ = PM.prefill(model, params, {"tokens": toks})
        card = PM.tree_map(lambda t: t.to(cuda), params)
        flash_kernel.launches = 0
        got, _ = PM.prefill(model, card, {"tokens": toks.to(cuda)})
    assert flash_kernel.launches == cfg.n_layers
    tol = dict(rtol=1e-3, atol=1e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **tol)
