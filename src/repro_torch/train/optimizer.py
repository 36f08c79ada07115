"""Optimizers: AdamW (fp32 moments) and AdamW8 (blockwise-int8 moments).

AdamW8 stores both moments as int8 with one fp32 absmax scale per 256-value
block — 2.25 bytes/param of optimizer state instead of 8.  Quantization
error is bounded by absmax scaling and converges within noise of fp32 Adam
on the reduced LM (examples/train_lm_torch.py --opt adamw8).

The JAX package's arithmetic, on the port's parameter trees (nested dicts
and tuples of tensors, stacked groups as they are).  An update runs under
``torch.no_grad()``, one leaf at a time, and returns new trees; the inputs
are not modified.  What keeps it equal to the reference:

- leaves are taken with dict keys in sorted order, as ``jax.tree.leaves``
  takes them, so the global norm sums its per-leaf terms in the
  reference's order;
- the reference's Python-float hyperparameters meet float32 arrays as weak
  types, so ``lr``, ``b1**step`` and ``b2**step`` are float32: here they
  are float32 tensors on the parameters' device, never Python floats;
- ``step`` is a 0-d int32 tensor, as in the reference, so that
  checkpoints of either package restore in the other;
- ``torch.round``, like ``jnp.round``, rounds half to even.
"""

from __future__ import annotations

import dataclasses
import math

import torch

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ------------------------------------------------------------------- trees


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts / tuples / lists, dict keys sorted
    (``jax.tree.leaves``'s order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def leaves_up_to(structure, tree) -> list:
    """``tree``'s subtrees at the leaf positions of ``structure``, in
    ``tree_leaves`` order (``treedef.flatten_up_to``)."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure) for x in leaves_up_to(structure[k], tree[k])]
    if isinstance(structure, (tuple, list)):
        return [x for s, t in zip(structure, tree) for x in leaves_up_to(s, t)]
    return [tree]


def tree_unflatten(structure, values) -> object:
    """A tree shaped like ``structure`` holding ``values`` (in
    ``tree_leaves`` order) at its leaves."""
    it = iter(values)

    def build(s):
        if isinstance(s, dict):
            out = {k: None for k in s}  # keep the caller's key order
            for k in sorted(s):
                out[k] = build(s[k])
            return out
        if isinstance(s, (tuple, list)):
            return type(s)(build(v) for v in s)
        return next(it)

    return build(structure)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# ----------------------------------------------------------------- schedule


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup then cosine decay to ``min_lr_frac``; float32 like the
    reference's (``step`` an int32 tensor)."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = _f32(0.0, leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm, norm=None):
    """``norm``: the tree's global norm when the caller has it (a sharded
    tree's, summed over its ranks)."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    clipped = [(x.float() * scale).to(x.dtype) for x in tree_leaves(tree)]
    return tree_unflatten(tree, clipped), norm


def _bias_corrections(b1: float, b2: float, step: torch.Tensor):
    """(1 - b1**step, 1 - b2**step) in float32."""
    s = step.float()
    return 1 - torch.pow(_f32(b1, s.device), s), 1 - torch.pow(_f32(b2, s.device), s)


# ------------------------------------------------------------------- AdamW


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    flat = tree_leaves(params)
    return {
        "m": tree_unflatten(params, [zeros(p) for p in flat]),
        "v": tree_unflatten(params, [zeros(p) for p in flat]),
        "step": torch.zeros((), dtype=torch.int32, device=flat[0].device),
    }


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig, gnorm=None):
    """``gnorm``: the gradients' global norm when the leaves are one rank's
    shards (the sharded step computes it over the ranks)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    c1, c2 = _bias_corrections(b1, b2, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)

    def upd(p, g, m, v):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    flat_p = tree_leaves(params)
    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, leaves_up_to(params, grads), leaves_up_to(params, state["m"]),
        leaves_up_to(params, state["v"]))]
    new_params = tree_unflatten(params, [o[0] for o in outs])
    new_m = tree_unflatten(params, [o[1] for o in outs])
    new_v = tree_unflatten(params, [o[2] for o in outs])
    return new_params, {"m": new_m, "v": new_v, "step": step}, {"lr": lr, "grad_norm": gnorm}


# ----------------------------------------------------------- blockwise int8


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division on every device: CUDA divides by a
    Python scalar as a product with its reciprocal, a last bit apart from
    the CPU's (and the reference's) quotient; by a 0-d tensor on ``x``'s
    device it divides."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _q8(x32: torch.Tensor):
    """fp32 (N,) -> (int8 codes (blocks, BLOCK), fp32 scales (blocks,))."""
    n = x32.numel()
    pad = (-n) % BLOCK
    xp = torch.nn.functional.pad(x32.reshape(-1), (0, pad)).reshape(-1, BLOCK)
    scale = _div(torch.amax(torch.abs(xp), dim=1), 127.0)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xp / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.float() * scale[:, None]).reshape(-1)
    return x[:math.prod(shape)].reshape(shape)


# Second moments span many orders of magnitude WITHIN a block (hot vs cold
# rows of an embedding), so absmax-int8 flushes cold entries to zero and the
# Adam denominator 1/(sqrt(0)+eps) explodes.  v is therefore quantized in
# LOG space: 255 levels over the block's log-range keeps relative error
# ~exp(range/254)-1 (~12% at 30 nats) — harmless for the denominator.


def _q8log(v32: torch.Tensor):
    n = v32.numel()
    pad = (-n) % BLOCK
    u = torch.log(torch.clamp_min(v32.reshape(-1), 1e-30))
    up = torch.nn.functional.pad(u, (0, pad), value=-69.0).reshape(-1, BLOCK)
    mn = up.amin(dim=1)
    mx = up.amax(dim=1)
    scale = torch.clamp_min(_div(mx - mn, 254.0), 1e-12)
    q = torch.clamp(torch.round((up - mn[:, None]) / scale[:, None]), 0, 254)
    return (q - 127).to(torch.int8), scale.float(), mn.float()


def _dq8log(q: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor, shape) -> torch.Tensor:
    u = (q.float() + 127.0) * scale[:, None] + mn[:, None]
    x = torch.exp(u).reshape(-1)
    out = x[:math.prod(shape)].reshape(shape)
    return torch.where(out <= 2e-30, 0.0, out)


def adamw8_init(params):
    def zeros_m(p):
        blocks = -(-p.numel() // BLOCK)
        return {
            "q": torch.zeros((blocks, BLOCK), dtype=torch.int8, device=p.device),
            "s": torch.zeros((blocks,), dtype=torch.float32, device=p.device),
        }

    def zeros_v(p):
        blocks = -(-p.numel() // BLOCK)
        return {
            "q": torch.zeros((blocks, BLOCK), dtype=torch.int8, device=p.device),
            "s": torch.zeros((blocks,), dtype=torch.float32, device=p.device),
            "mn": torch.full((blocks,), -69.0, dtype=torch.float32, device=p.device),  # log(~1e-30)
        }

    flat = tree_leaves(params)
    return {
        "m": tree_unflatten(params, [zeros_m(p) for p in flat]),
        "v": tree_unflatten(params, [zeros_v(p) for p in flat]),
        "step": torch.zeros((), dtype=torch.int32, device=flat[0].device),
    }


@torch.no_grad()
def adamw8_update(params, grads, state, cfg: OptConfig, gnorm=None):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    c1, c2 = _bias_corrections(b1, b2, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)

    def upd(p, g, mq, vq):
        g = g.float()
        m = _dq8(mq["q"], mq["s"], p.shape)
        v = _dq8log(vq["q"], vq["s"], vq["mn"], p.shape)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(torch.clamp_min(vh, 0)) + cfg.eps) + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        q_m, s_m = _q8(m)
        q_v, s_v, mn_v = _q8log(v)
        return new_p, {"q": q_m, "s": s_m}, {"q": q_v, "s": s_v, "mn": mn_v}

    flat_p = tree_leaves(params)
    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, leaves_up_to(params, grads), leaves_up_to(params, state["m"]),
        leaves_up_to(params, state["v"]))]
    new_params = tree_unflatten(params, [o[0] for o in outs])
    new_m = tree_unflatten(params, [o[1] for o in outs])
    new_v = tree_unflatten(params, [o[2] for o in outs])
    return new_params, {"m": new_m, "v": new_v, "step": step}, {"lr": lr, "grad_norm": gnorm}


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adamw8": (adamw8_init, adamw8_update),
}
