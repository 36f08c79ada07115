"""The train step: loss -> grads -> optimizer, with microbatch accumulation.

`make_train_step` returns a function
    (params, opt_state, batch) -> (params, opt_state, metrics)
over the port's parameter trees.  The gradient is ``torch.autograd.grad`` of
``models.model.forward_train`` with respect to every parameter leaf; a leaf
the loss does not reach (rwkv's unused ``norm1``) gets zeros of its shape
and dtype, as ``jax.grad`` gives it, so weight decay still moves it.
Gradient accumulation loops over microbatches (keeps the per-microbatch
activation peak at 1/k of the full batch), summing in fp32 as the
reference's scan does, and an optional int8 gradient compression hook
quantizes gradients before the optimizer.

The reference's ``grad_pspecs`` and ``batch_shardings`` (sharding
constraints on the gradient accumulator and the microbatched batch) wait
for the port's mesh slice: without a mesh there is nothing to constrain.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as Mod
from repro_torch.train import optimizer as Opt


def _compress_grads_int8(grads):
    """Blockwise-int8 quantize-dequantize of gradients.  Placed between the
    backward pass and the optimizer so the all-reduce operates on values that
    survive int8 transport; here it models the numerics."""
    def qdq(g):
        q, s = Opt._q8(g.float())
        return Opt._dq8(q, s, g.shape).to(g.dtype)
    with torch.no_grad():
        return Mod.tree_map(qdq, grads)


def make_train_step(
    model: Mod.Model,
    opt_name: str = "adamw",
    opt_cfg: Opt.OptConfig | None = None,
    microbatches: int = 1,
    ce_chunk: int = 512,
    compress_grads: bool = False,
):
    opt_cfg = opt_cfg or Opt.OptConfig()
    _, opt_update = Opt.OPTIMIZERS[opt_name]

    def value_and_grad(params, batch):
        """(loss, grads): grads in the parameters' dtypes, zeros where the
        loss does not reach a leaf."""
        flat = Opt.tree_leaves(params)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in flat]
            loss = Mod.forward_train(model, Opt.tree_unflatten(params, leaves), batch,
                                     ce_chunk=ce_chunk)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"a batch of {B} does not split into {microbatches} microbatches")
            mb = B // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in Opt.tree_leaves(params)]
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = value_and_grad(params, part)
                grads = [a + b.float() for a, b in zip(grads, g)]
                loss = loss + l
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        grads = Opt.tree_unflatten(params, grads)

        with torch.profiler.record_function("train_step.optimizer"):
            if compress_grads:
                grads = _compress_grads_int8(grads)
            params, opt_state, om = opt_update(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics

    return train_step


def make_init(model: Mod.Model, opt_name: str = "adamw"):
    """``init(generator) -> (params, opt_state)``: the model's weights drawn
    from ``generator`` on its device, and the optimizer's zero state."""
    opt_init, _ = Opt.OPTIMIZERS[opt_name]

    def init(generator: torch.Generator):
        params = Mod.init_params(model, generator)
        return params, opt_init(params)

    return init
