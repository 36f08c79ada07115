"""Gradients of the port's ``models.model.forward_train`` (remat around
each group body, ``torch.autograd``) against ``jax.grad`` of the JAX
package's, on the CPU, for the ten reduced architectures in float32 and
bfloat16.  Both packages run the reference's seeded weights
(``convert.lm_params_from_reference``) on one numpy batch.  A leaf the
port's loss does not reach (rwkv6's ``groups/0/norm1``: autograd gives
None) is compared as zeros, which is what ``jax.grad`` gives.

Tolerances.
- float32: each leaf within 1e-4 of its largest entry (read: at most 1e-5,
  jamba's ``mamba`` leaves).
- bfloat16: eager PyTorch rounds every op's output to bf16, while XLA's
  fused kernels keep a chain of elementwise ops in fp32 and round once, so
  the reference's jitted bf16 gradients are not the arithmetic the port
  does (jamba's lie 1.7 of a leaf's largest entry from the reference's own
  op-by-op run, kimi's 0.18).  The bf16 gradients are held against
  ``jax.grad`` run op by op (``jax.disable_jit()``, each primitive rounding
  its output as the port does), at test_torch_lm.py's bf16 bar: 2e-2 of
  the leaf's largest entry, or twice the distance between the reference's
  own op-by-op bf16 gradient of that leaf and its float32 one where that
  is more (read: at most 0.61 of the bar).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.models import model as PM
from repro_torch.train import optimizer as Opt

try:  # the reference: on the CPU host; the card's host has no JAX
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import model as RM
except ImportError:
    jax = None
needs_reference = pytest.mark.skipif(jax is None, reason="needs the JAX package")

B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batch(cfg, rng) -> dict:
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _ref_setup(arch, dtype):
    cfg = dataclasses.replace(ref_configs.get(arch, reduced=True), dtype=dtype)
    model = RM.build(cfg)
    params = RM.init_params(model, jax.random.key(0))  # bf16 where the config says
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return cfg, model, params


def _port_grads(arch, dtype, ref_params, batch):
    model = PM.build(dataclasses.replace(configs.get(arch, reduced=True), dtype=dtype))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref_params), "cpu")
    flat = Opt.tree_leaves(params)
    leaves = [p.requires_grad_(True) for p in flat]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = PM.forward_train(model, Opt.tree_unflatten(params, leaves), tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]


@needs_reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_forward_train_gradients_match_jax_grad(arch, dtype):
    cfg, model, params = _ref_setup(arch, "float32")
    batch = _batch(cfg, np.random.default_rng(sum(map(ord, cfg.name))))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p, b):
        return RM.forward_train(model, p, b)

    ref_loss, ref32 = jax.jit(jax.value_and_grad(loss_fn))(params, jb)
    ref32 = [np.asarray(g) for g in jax.tree.leaves(ref32)]
    if dtype == "bfloat16":
        _, bmodel, params = _ref_setup(arch, "bfloat16")
        with jax.disable_jit():  # op by op: each primitive rounds to bf16, as eager torch
            ref_loss, ref = jax.value_and_grad(lambda p, b: RM.forward_train(bmodel, p, b))(
                params, jb)
        ref = [np.asarray(g, np.float32) for g in jax.tree.leaves(ref)]
    else:
        ref = ref32
    loss, grads = _port_grads(arch, dtype, params, batch)
    dtypes = [str(x.dtype) for x in jax.tree.leaves(params)]
    assert len(grads) == len(ref) == len(dtypes)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    for i, (g, want, want32) in enumerate(zip(grads, ref, ref32)):
        got = g.float().numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), (arch, i)
        assert str(g.dtype)[6:] == dtypes[i], (arch, i)  # the parameter's dtype
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if dtype == "float32":
            assert err <= 1e-4 * scale, f"{arch} leaf {i}: {err:.3e} > 1e-4 x {scale:.3e}"
        else:
            bar = max(2e-2 * scale, 2 * float(np.abs(want - want32).max()))
            assert err <= bar, f"{arch} leaf {i}: {err:.3e} > {bar:.3e}"
