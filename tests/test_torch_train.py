"""The port's training path (repro_torch.train, models.forward_train under
autograd, layers.FlashAttention) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's weights and optimizer state are carried across by
``convert.lm_params_from_reference`` and ``convert.opt_state_from_reference``.

The ``forward_train`` gradients of the ten architectures are in
``test_torch_grads.py``.

Tolerances.
- One train step in float32 from converted state: loss and ``grad_norm``
  rtol 1e-5, ``lr`` rtol 1e-6; parameters within 1e-5 of each leaf's
  largest entry, except entries whose gradient in both packages is under
  1e-4 of the leaf's largest gradient: Adam's step is about ±lr whatever
  |g|, so a gradient that sums to nearly zero may step the other way and
  move an entry by up to 2 lr.
- The optimizers fed the same numpy gradients: AdamW params within 1e-6
  relative, moments within 1e-6 relative or 1e-6 of the leaf's largest
  entry (m sums terms of both signs, so a small entry carries the rounding
  of large ones); AdamW8 codes equal except at most 0.1 % off by one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import model as PM
from repro_torch.train import data as Data
from repro_torch.train import optimizer as Opt
from repro_torch.train import train_step as TS

try:  # the reference: on the CPU host; the card's host has no JAX
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import layers as RL
    from repro.models import model as RM
    from repro.train import optimizer as ROpt
    from repro.train import train_step as RTS
except ImportError:
    jax = None
needs_reference = pytest.mark.skipif(jax is None, reason="needs the JAX package")

S = 16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------- ports of tests/test_train.py (the port trains)


@pytest.fixture(scope="module")
def tiny():
    cfg = configs.get("tinyllama-1.1b", reduced=True)
    return cfg, PM.build(cfg)


def _init(opt_name, seed=0):
    """The reference test's starting point: its ``jax.random.key(seed)``
    weights (the port's generator draws other numbers from the same seed,
    and those tests' thresholds were set on the reference's seed-0 draw),
    and the port's zero optimizer state."""
    rmodel = RM.build(ref_configs.get("tinyllama-1.1b", reduced=True))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, RM.init_params(rmodel, jax.random.key(seed))), "cpu")
    return params, Opt.OPTIMIZERS[opt_name][0](params)


def _run(model, cfg, opt_name, steps=40, compress=False, seed=0):
    opt_cfg = Opt.OptConfig(lr=3e-3, total_steps=steps, warmup_steps=2)
    step_fn = TS.make_train_step(model, opt_name=opt_name, opt_cfg=opt_cfg, ce_chunk=32,
                                 compress_grads=compress)
    params, opt_state = _init(opt_name, seed)
    dcfg = Data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=seed)
    losses = []
    for step in range(steps):
        batch = _torch_batch({k: v for k, v in Data.batch_for_step(dcfg, step).items()
                              if not k.startswith("_")})
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
    return losses


@needs_reference
def test_loss_decreases(tiny):
    cfg, model = tiny
    losses = _run(model, cfg, "adamw")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::8]


@needs_reference
def test_adamw8_tracks_adamw(tiny):
    """Blockwise-int8 moments must land within noise of fp32 Adam."""
    cfg, model = tiny
    l32 = _run(model, cfg, "adamw", steps=30)
    l8 = _run(model, cfg, "adamw8", steps=30)
    assert abs(np.mean(l8[-5:]) - np.mean(l32[-5:])) < 0.3, (l32[-5:], l8[-5:])


@needs_reference
def test_grad_compression_trains(tiny):
    cfg, model = tiny
    losses = _run(model, cfg, "adamw", steps=30, compress=True)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


@needs_reference
def test_microbatch_equivalence(tiny):
    """Grad accumulation over k microbatches == one big batch (same loss path)."""
    cfg, model = tiny
    opt_cfg = Opt.OptConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    params, opt_state = _init("adamw")
    dcfg = Data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    batch = _torch_batch({k: v for k, v in Data.batch_for_step(dcfg, 0).items()
                          if not k.startswith("_")})
    outs = {}
    for mb in (1, 4):
        step_fn = TS.make_train_step(model, opt_name="adamw", opt_cfg=opt_cfg,
                                     microbatches=mb, ce_chunk=32)
        p2, _, m = step_fn(params, opt_state, batch)
        outs[mb] = (float(m["loss"]), p2)
    assert abs(outs[1][0] - outs[4][0]) < 2e-2
    # parameters after one step agree to accumulation tolerance
    for a, b in zip(Opt.tree_leaves(outs[1][1]), Opt.tree_leaves(outs[4][1])):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-2)


def test_int8_quantizer_roundtrip():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1000) * 3.0).astype(np.float32))
    q, s = Opt._q8(x)
    back = Opt._dq8(q, s, (1000,))
    err = float((back - x).abs().max())
    assert err < 3.0 / 127 * 3.5  # within a few quantization steps


def test_update_leaves_its_inputs_alone(tiny):
    """The step returns new trees, as the reference's does."""
    cfg, model = tiny
    params, opt_state = TS.make_init(model, "adamw")(torch.Generator().manual_seed(0))
    before = [t.clone() for t in Opt.tree_leaves((params, opt_state))]
    dcfg = Data.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=0)
    batch = _torch_batch({k: v for k, v in Data.batch_for_step(dcfg, 0).items()
                          if not k.startswith("_")})
    new_p, new_s, _ = TS.make_train_step(model)(params, opt_state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, Opt.tree_leaves((params, opt_state))))
    assert int(new_s["step"]) == 1 and new_s["step"].dtype == torch.int32
    assert not all(torch.equal(a, b) for a, b in
                   zip(Opt.tree_leaves(params), Opt.tree_leaves(new_p)))


def test_tree_order_is_jax_order():
    """Leaves with dict keys sorted, tuples in order; unflatten inverts it."""
    tree = {"b": (torch.tensor(1), {"z": torch.tensor(2), "a": torch.tensor(3)}),
            "a": torch.tensor(4)}
    assert [int(t) for t in Opt.tree_leaves(tree)] == [4, 1, 3, 2]
    back = Opt.tree_unflatten(tree, [t * 10 for t in Opt.tree_leaves(tree)])
    assert list(back) == ["b", "a"] and int(back["b"][1]["a"]) == 30


def test_cli_reduced_flag_can_be_turned_off():
    """The reference's --reduced is store_true with default True; the port's
    is a BooleanOptionalAction, so --no-reduced takes the published widths."""
    ap = train_cli.parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args([]).device == "cuda"


# ------------------------------------------------------- against the JAX package


def _ref_setup(arch, dtype):
    cfg = dataclasses.replace(ref_configs.get(arch, reduced=True), dtype=dtype)
    model = RM.build(cfg)
    params = RM.init_params(model, jax.random.key(0))  # bf16 where the config says
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return cfg, model, params


def _ref_leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


STEP_CASES = {
    "adamw": dict(opt_name="adamw"),
    "adamw8": dict(opt_name="adamw8"),
    "microbatches4": dict(opt_name="adamw", microbatches=4),
    "compress_grads": dict(opt_name="adamw", compress_grads=True),
}


@needs_reference
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_the_reference(case):
    """Two reference steps from its own init, the state carried across, then
    one step in each package on the same batch."""
    kw = STEP_CASES[case]
    cfg, rmodel, params = _ref_setup("tinyllama-1.1b", "float32")
    opt_cfg = ROpt.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    ref_step = jax.jit(RTS.make_train_step(rmodel, opt_cfg=opt_cfg, ce_chunk=8, **kw))
    opt_state = ROpt.OPTIMIZERS[kw["opt_name"]][0](params)
    dcfg = Data.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=4, seed=5)
    batches = [{k: v for k, v in Data.batch_for_step(dcfg, s).items() if not k.startswith("_")}
               for s in range(3)]
    for b in batches[:2]:
        params, opt_state, _ = ref_step(params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})

    model = PM.build(dataclasses.replace(configs.get("tinyllama-1.1b", reduced=True),
                                         dtype="float32"))
    p0 = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    s0 = convert.opt_state_from_reference(jax.tree.map(np.asarray, opt_state), "cpu")
    port_cfg = Opt.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    p1, s1, m = TS.make_train_step(model, opt_cfg=port_cfg, ce_chunk=8, **kw)(
        p0, s0, _torch_batch(batches[2]))
    rb = {k: jnp.asarray(v) for k, v in batches[2].items()}
    r1, rs1, rm = ref_step(params, opt_state, rb)
    _, rgrads = jax.jit(jax.value_and_grad(lambda p, b: RM.forward_train(rmodel, p, b,
                                                                          ce_chunk=8)))(params, rb)

    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
    assert m["lr"].dtype == torch.float32 and int(s1["step"]) == int(rs1["step"]) == 3
    lr = float(rm["lr"])
    for got, want, start, g in zip(Opt.tree_leaves(p1), _ref_leaves_np(r1),
                                   _ref_leaves_np(params), _ref_leaves_np(rgrads)):
        got = _np(got)
        scale = float(np.abs(want).max())
        off = np.abs(got - want) > 1e-5 * scale
        # where the gradient nearly cancels, Adam may step the other way
        tiny = np.abs(g) < 1e-4 * max(float(np.abs(g).max()), 1e-30)
        assert not (off & ~tiny).any(), float(np.abs(got - want)[off & ~tiny].max())
        assert (np.abs(got - want) <= 2 * lr + 1e-5 * scale).all()
        assert np.isfinite(got).all() and not np.array_equal(got, start)


def _opt_trees(rng):
    """A parameter tree with the model's nesting (dicts, a tuple of dicts,
    stacked leaves), float32 and bfloat16 leaves, and a leaf whose size is
    not a multiple of the int8 block."""
    shapes = {"embed": (40, 16), "final_norm": (16,),
              "groups": ({"attn": {"wq": (2, 16, 16)}, "norm1": (2, 16)},
                         {"ffn": {"w_up": (2, 16, 33)}})}

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        if isinstance(s, tuple) and isinstance(s[0], dict):
            return tuple(draw(v, scale) for v in s)
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return draw(shapes, 0.5), [draw(shapes, 0.1) for _ in range(3)]


def _to_torch(tree, bf16_keys=("embed",)):
    def conv(t, key=None):
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(conv(v) for v in t)
        x = torch.from_numpy(t)
        return x.to(torch.bfloat16) if key in bf16_keys else x
    return conv(tree)


def _to_jax(tree, bf16_keys=("embed",)):
    def conv(t, key=None):
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(conv(v) for v in t)
        return jnp.asarray(t, jnp.bfloat16 if key in bf16_keys else jnp.float32)
    return conv(tree)


@needs_reference
@pytest.mark.parametrize("opt_name", ["adamw", "adamw8"])
def test_optimizers_match_the_reference_on_the_same_gradients(opt_name):
    params, grads = _opt_trees(np.random.default_rng(11))
    cfg = Opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    rcfg = ROpt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    r_init, r_update = ROpt.OPTIMIZERS[opt_name]
    p_init, p_update = Opt.OPTIMIZERS[opt_name]
    rp, pp = _to_jax(params), _to_torch(params)
    rs, ps = r_init(rp), p_init(pp)
    update = jax.jit(lambda p, g, s: r_update(p, g, s, rcfg))
    for g in grads:
        rp, rs, rm = update(rp, _to_jax(g), rs)
        pp, ps, pm = p_update(pp, _to_torch(g), ps, cfg)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
    for got, want in zip(Opt.tree_leaves(pp), _ref_leaves_np(rp)):
        assert str(got.dtype)[6:] == str(want.dtype)
        np.testing.assert_allclose(_np(got), want.astype(np.float32), rtol=1e-6, atol=1e-7)
    ref_state = jax.tree.map(np.asarray, rs)
    assert int(ps["step"]) == int(ref_state["step"]) == len(grads)
    for got, want in zip(Opt.tree_leaves(ps), jax.tree.leaves(ref_state)):
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == np.int8:  # codes: equal but for rare off-by-one roundings
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff > 0).mean()
        else:  # moments sum terms of both signs: held to their leaf's scale
            np.testing.assert_allclose(got, want, rtol=1e-6 if opt_name == "adamw" else 1e-5,
                                       atol=1e-6 * float(np.abs(want).max()))


@needs_reference
@pytest.mark.parametrize("step", [0, 1, 2, 5, 9, 10, 11])
def test_schedule_matches_the_reference(step):
    cfg = Opt.OptConfig(lr=3e-3, warmup_steps=3, total_steps=10)
    rcfg = ROpt.OptConfig(lr=3e-3, warmup_steps=3, total_steps=10)
    got = Opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jax.jit(lambda s: ROpt.schedule(rcfg, s))(jnp.int32(step))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------- the card's attention under autograd


ATTN_CASES = {  # name: (H, KVH, Sq, Skv, causal, window, block)
    "causal_gqa": (4, 2, 24, 24, True, 0, 8),
    "windowed_gqa": (4, 2, 24, 24, True, 8, 8),
    "causal_right_aligned": (4, 1, 12, 24, True, 0, 16),
    "full_mha": (2, 2, 20, 20, False, 0, 8),
}


@needs_reference
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_function_gradients(case):
    """``FlashAttention`` on CPU tensors (its forward is the flash kernel's
    plain version): the forward equals the streaming recurrence's, the
    gradients equal autograd of that recurrence bit for bit (the backward
    is that recurrence), and both are within 1e-5 of ``jax.grad`` of the
    reference's ``chunked_attention``."""
    H, KVH, Sq, Skv, causal, window, block = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, H, Sq, 16), (2, KVH, Skv, 16), (2, KVH, Skv, 16)))
    w = rng.standard_normal((2, H, Sq, 16)).astype(np.float32)

    def port(fn):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = fn(*ts)
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
        return out.detach(), grads

    out_fn, g_fn = port(lambda *t: L.FlashAttention.apply(*t, causal, window, block))
    out_pl, g_pl = port(lambda *t: L._streaming_attention(*t, causal, window, block, None))
    np.testing.assert_allclose(out_fn.numpy(), out_pl.numpy(), rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(g_fn, g_pl))

    def ref_loss(q_, k_, v_):
        out = RL.chunked_attention(q_, k_, v_, causal=causal, window=window, block=block)
        return jnp.sum(out * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip(g_fn, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_flash_attention_function_only_where_a_gradient_is_asked_for():
    """On the CPU ``chunked_attention`` is the recurrence under autograd, the
    Function returns no gradient for an input that needs none."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 8, 16)).astype(np.float32))
    kk = k.clone().requires_grad_(True)
    out = L.FlashAttention.apply(q, kk, k, True, 0, 512)
    (gk,) = torch.autograd.grad(out.sum(), [kk])
    assert gk.shape == k.shape and torch.isfinite(gk).all()
    got = L.chunked_attention(q, kk, k)
    assert got.grad_fn is not None and "FlashAttention" not in type(got.grad_fn).__name__
