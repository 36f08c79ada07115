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

Under an active mesh (``models.sharding``) the parameters, the AdamW
moments and the batch are DTensors and the step is this rank's part of the
sharded program.  Microbatch i is rows i*mb .. (i+1)*mb of the global
batch, as the reference's static reshape cuts it, placed by
``batch_shardings(ndim)`` (default: the batch's own placements) so every DP
shard holds its share of each microbatch: the rows move by one all-to-all
over the DP ranks a step (``Sharding.microbatch_parts``), where GSPMD
reshards the reshaped batch.  A MoE's capacity groups are therefore the
reference's.
The gradients and the fp32 accumulator carry the params' placements
(``to_local``'s backward gives them); ``grad_pspecs``, where given, is
checked against them.  The optimizer state is placed by
``opt_state_placements``, the reference's specs: AdamW's moments mirror the
params and update on each rank's shards; adamw8's blockwise codes are
replicated and update each leaf over its global extent (the full gradient
and parameter gathered, one leaf at a time), so the codes are the
unsharded step's; the new parameter is this rank's slice.  Either way the
gradient norm is the global one, summed over the ranks, and
``compress_grads`` quantizes each gradient over its global blocks too.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import model as Mod
from repro_torch.models import sharding as Sh
from repro_torch.train import optimizer as Opt


# optimizers whose state is elementwise: their moments mirror the params
# and update shard by shard; any other's state is replicated
ELEMENTWISE = ("adamw",)


def opt_state_placements(opt_name: str, opt_state, param_placements, mesh):
    """The placements tree of ``opt_state`` on ``mesh`` (``Sh.place``'s
    argument), the reference's dry-run specs: AdamW's moments mirror their
    parameters' placements; every leaf of adamw8's blockwise state is
    replicated.  ``step`` stays a plain (replicated) tensor."""
    if opt_name in ELEMENTWISE:
        return {"m": param_placements, "v": param_placements, "step": None}
    rep = Sh.placements_of(mesh, ())
    every = {k: Sh.tree_map_with_path(lambda path, leaf: rep, opt_state[k]) for k in ("m", "v")}
    return {**every, "step": None}


def _qdq(g):
    q, s = Opt._q8(g.float())
    return Opt._dq8(q, s, g.shape).to(g.dtype)


def _compress_grads_int8(grads):
    """Blockwise-int8 quantize-dequantize of gradients.  Placed between the
    backward pass and the optimizer so the all-reduce operates on values that
    survive int8 transport; here it models the numerics.  A DTensor gradient
    is quantized over its global extent, blocks of 256 over the flattened
    full tensor as GSPMD computes the reference's hook, and handed back
    placed like itself."""
    def one(g):
        if isinstance(g, DTensor):
            return Sh.shard_like(_qdq(Sh.full(g)), g)
        return _qdq(g)
    with torch.no_grad():
        return Mod.tree_map(one, grads)


def loss_and_grads(model: Mod.Model, params, batch, ce_chunk: int = 512):
    """(loss, grads) of ``forward_train`` on one batch: the grads a flat list
    in ``Opt.tree_leaves(params)``'s order, in the parameters' dtypes, zeros
    where the loss does not reach a leaf."""
    flat = Opt.tree_leaves(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = Mod.forward_train(model, Opt.tree_unflatten(params, leaves), batch,
                                 ce_chunk=ce_chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]


def make_train_step(
    model: Mod.Model,
    opt_name: str = "adamw",
    opt_cfg: Opt.OptConfig | None = None,
    microbatches: int = 1,
    ce_chunk: int = 512,
    compress_grads: bool = False,
    grad_pspecs=None,      # placements tree matching params: checked (under a mesh)
    batch_shardings=None,  # ndim -> placements of one microbatch leaf
):
    opt_cfg = opt_cfg or Opt.OptConfig()
    _, opt_update = Opt.OPTIMIZERS[opt_name]

    def value_and_grad(params, batch):
        loss, grads = loss_and_grads(model, params, batch, ce_chunk)
        if grad_pspecs is not None:
            for g, pl in zip(grads, Opt.leaves_up_to(params, grad_pspecs)):
                if tuple(g.placements) != tuple(pl):
                    raise ValueError(f"a gradient placed {tuple(g.placements)}, "
                                     f"not like its parameter's spec {tuple(pl)}")
        return loss, grads

    def _zeros_f32(p):
        """The fp32 accumulator of ``p``'s gradient, placed like ``p``."""
        if isinstance(p, DTensor):
            return Sh.wrap_like(torch.zeros(p.to_local().shape, dtype=torch.float32,
                                            device=p.device), p)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def _microbatches(v, mb: int) -> list:
        """Rows i*mb .. (i+1)*mb of the batch leaf ``v``, i < microbatches; of
        a DTensor leaf this rank's share of them under ``batch_shardings``."""
        if not isinstance(v, DTensor):
            return list(v.split(mb))
        placements = batch_shardings(v.dim()) if batch_shardings is not None else v.placements
        parts = Sh.microbatch_parts(v.to_local(), any(pl.is_shard() for pl in v.placements),
                                    any(pl.is_shard() for pl in placements), microbatches)
        return [DTensor.from_local(part, v.device_mesh, placements, run_check=False,
                                   shape=(mb,) + tuple(v.shape[1:]), stride=part.stride())
                for part in parts]

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"a batch of {B} does not split into {microbatches} microbatches")
            mb = B // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = [_zeros_f32(p) for p in Opt.tree_leaves(params)]
            parts = {k: _microbatches(v, mb) for k, v in batch.items()}
            for i in range(microbatches):
                l, g = value_and_grad(params, {k: v[i] for k, v in parts.items()})
                grads = [a + b.float() for a, b in zip(grads, g)]
                loss = loss + l
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        grads = Opt.tree_unflatten(params, grads)

        with torch.profiler.record_function("train_step.optimizer"):
            if compress_grads:
                grads = _compress_grads_int8(grads)
            if Sh.active():
                params, opt_state, om = _sharded_update(opt_name, opt_update, params, grads,
                                                        opt_state, opt_cfg)
            else:
                params, opt_state, om = opt_update(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics

    return train_step


def _sharded_update(opt_name, opt_update, params, grads, opt_state, opt_cfg):
    """The optimizer under a mesh, the gradient norm summed over the ranks:
    an elementwise optimizer on this rank's shards (DTensor leaves -> their
    local tensors and back, with the same placements); any other one leaf
    at a time over the leaf's global extent, its replicated state updated
    whole on every rank and this rank's slice of the new parameter kept."""
    flat_p = Opt.tree_leaves(params)
    flat_g = Opt.leaves_up_to(params, grads)
    for p, g in zip(flat_p, flat_g):
        if tuple(g.placements) != tuple(p.placements):
            raise ValueError(f"a gradient placed {tuple(g.placements)} reaches the optimizer "
                             f"beside its parameter's {tuple(p.placements)}")
    gnorm = torch.sqrt(Sh.global_sq_sum(flat_g))

    def local(tree):
        return Mod.tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)

    def wrap(new, like):
        return Sh.wrap_like(new, like) if isinstance(like, DTensor) else new

    if opt_name in ELEMENTWISE:
        new_p, new_s, om = opt_update(local(params), local(grads), local(opt_state), opt_cfg,
                                      gnorm=gnorm)
        return Mod.tree_map(wrap, new_p, params), Mod.tree_map(wrap, new_s, opt_state), om
    outs = []
    for p, g, m, v in zip(flat_p, flat_g, Opt.leaves_up_to(params, opt_state["m"]),
                          Opt.leaves_up_to(params, opt_state["v"])):
        full_p, s, om = opt_update(Sh.full(p), Sh.full(g),
                                   {"m": local(m), "v": local(v), "step": opt_state["step"]},
                                   opt_cfg, gnorm=gnorm)
        outs.append((Sh.shard_like(full_p, p), Mod.tree_map(wrap, s["m"], m),
                     Mod.tree_map(wrap, s["v"], v)))
    new_s = {k: Opt.tree_unflatten(params, [o[i] for o in outs]) for i, k in ((1, "m"), (2, "v"))}
    return Opt.tree_unflatten(params, [o[0] for o in outs]), {**new_s, "step": s["step"]}, om


def make_init(model: Mod.Model, opt_name: str = "adamw"):
    """``init(generator) -> (params, opt_state)``: the model's weights drawn
    from ``generator`` on its device, and the optimizer's zero state."""
    opt_init, _ = Opt.OPTIMIZERS[opt_name]

    def init(generator: torch.Generator):
        params = Mod.init_params(model, generator)
        return params, opt_init(params)

    return init
