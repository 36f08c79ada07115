"""The stacked model: init / train-forward loss / prefill / decode for all
families.

Layers are grouped into identical-spec groups of size lcm(kind-pattern,
window-pattern, moe-period), whose parameters are stacked along a leading
group axis; a loop over that axis takes the place of the reference's
``lax.scan``.  Layers that don't fit the periodic pattern (gemma3's 26 =
4*6+2, kimi's leading dense layer) run unrolled as a prefix.  Parameters
and caches are nested dicts and tuples of tensors with the reference's
structure, keys and shapes, so ``convert.lm_params_from_reference`` maps a
reference tree one to one.

``forward_train`` is differentiable on both devices: each group body runs
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` remat
around its scanned group body), so a backward recomputes one group at a
time, and the card's prefill attention is the flash kernel with the
streaming recurrence's backward (``layers.FlashAttention``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import reduce

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    prefix_specs: tuple[B.LayerSpec, ...]   # unrolled leading layers
    group_specs: tuple[B.LayerSpec, ...]    # slots of one stacked group
    n_groups: int
    # encoder (whisper): uniform non-causal attention layers, all stacked
    n_enc_groups: int = 0
    enc_group_specs: tuple[B.LayerSpec, ...] = ()


def _lcm(*xs: int) -> int:
    return reduce(math.lcm, [x for x in xs if x > 0], 1)


def build(cfg: ModelConfig) -> Model:
    group = _lcm(len(cfg.kind_pattern), len(cfg.window_pattern), cfg.moe_period)
    body = cfg.n_layers - cfg.first_dense
    group = min(group, max(1, body))
    prefix_len = cfg.first_dense + body % group
    n_groups = (cfg.n_layers - prefix_len) // group
    enc_specs = ()
    if cfg.n_encoder_layers:
        enc_specs = (B.LayerSpec(kind="attn", window=0, is_moe=False, cross=False,
                                 causal=False),)
    return Model(
        cfg=cfg,
        prefix_specs=tuple(B.LayerSpec.of(cfg, i) for i in range(prefix_len)),
        group_specs=tuple(B.LayerSpec.of(cfg, prefix_len + s) for s in range(group)),
        n_groups=n_groups,
        n_enc_groups=cfg.n_encoder_layers,
        enc_group_specs=enc_specs,
    )


# ------------------------------------------------------------- tree helpers


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts / tuples / lists."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _stack_into(out, g: int, n: int, tree):
    """Write ``tree`` as slot ``g`` of stacked leaves (allocated on g == 0)."""
    if out is None:
        out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), tree)
    tree_map(lambda o, t: o[g].copy_(t), out, tree)
    return out


def group_slice(stacked, g: int):
    """Group ``g`` of stacked leaves, as views."""
    return tree_map(lambda t: t[g], stacked)


def _unstack(stacked, n: int) -> list:
    """The ``n`` groups of stacked leaves, as views: one ``unbind`` a leaf,
    whose backward stacks the groups' gradients once (a ``t[g]`` per group
    would add a full-size gradient per group)."""
    parts = []
    tree_map(lambda t: parts.append(t.unbind(0)), stacked)
    groups = []
    for g in range(n):
        it = iter([p[g] for p in parts])
        groups.append(tree_map(lambda _: next(it), stacked))
    return groups


# ----------------------------------------------------------------------- init


def init_params(model: Model, generator: torch.Generator) -> dict:
    """Random weights drawn from ``generator`` on its device (the reference's
    shapes, dtypes and scales; not its values).  Stacked groups are filled
    in place, one group at a time."""
    cfg = model.cfg
    gen = generator
    dt = B.dtype_of(cfg)
    ones = dict(dtype=torch.float32, device=gen.device)
    params: dict = {
        "embed": L.init_linear(gen, (cfg.vocab_size, cfg.d_model), scale=0.02, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), **ones),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_linear(gen, (cfg.d_model, cfg.vocab_size), dtype=dt)
    if model.prefix_specs:
        params["prefix"] = tuple(B.init_layer(gen, cfg, s) for s in model.prefix_specs)
    if model.n_groups:
        stacked = None
        for g in range(model.n_groups):
            group = tuple(B.init_layer(gen, cfg, s) for s in model.group_specs)
            stacked = _stack_into(stacked, g, model.n_groups, group)
        params["groups"] = stacked
    if model.n_enc_groups:
        stacked = None
        for g in range(model.n_enc_groups):
            group = tuple(B.init_layer(gen, cfg, s) for s in model.enc_group_specs)
            stacked = _stack_into(stacked, g, model.n_enc_groups, group)
        params["encoder"] = {"groups": stacked,
                             "final_norm": torch.ones((cfg.d_model,), **ones)}
    return params


# ------------------------------------------------------------------- forward


def _unembed(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def _run_groups_seq(model, gparams, specs, n_groups, x, positions, enc_states, want_cache,
                    remat=False):
    """The stacked groups in order.  ``remat`` (with grad mode on): each
    group body runs under ``torch.utils.checkpoint``, which keeps only its
    inputs and recomputes the body in the backward."""
    cfg = model.cfg

    def body(gp, x):
        aux = 0.0
        group_caches = []
        for s, spec in enumerate(specs):
            x, cache, a = B.layer_seq(gp[s], x, cfg, spec, positions, enc_states, want_cache)
            aux = aux + a
            group_caches.append(cache)
        return x, aux, tuple(group_caches)

    aux = 0.0
    caches = None
    for g, gp in enumerate(_unstack(gparams, n_groups)):
        if remat and torch.is_grad_enabled():
            x, a, group_caches = checkpoint(body, gp, x, use_reentrant=False)
        else:
            x, a, group_caches = body(gp, x)
        aux = aux + a
        if want_cache:
            caches = _stack_into(caches, g, n_groups, group_caches)
    return x, aux, caches if want_cache else 0


def _embed_inputs(model: Model, params, batch):
    """Returns (x (B, S, d), positions (B, S), enc_states)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = L.embed(tokens, params["embed"])
    Btok, S = tokens.shape

    enc_states = None
    if cfg.frontend == "vision":
        patches = batch["patches"].to(x.dtype)           # (B, T_img, d) stub
        x = torch.cat([patches, x], dim=1)
        S = x.shape[1]
    if cfg.n_encoder_layers:
        frames = batch["frames"].to(x.dtype)             # (B, T_enc, d) stub
        positions_enc = torch.arange(frames.shape[1], device=x.device).expand(frames.shape[:2])
        h, _, _ = _run_groups_seq(model, params["encoder"]["groups"], model.enc_group_specs,
                                  model.n_enc_groups, frames, positions_enc, None, False,
                                  remat=True)
        enc_states = L.rmsnorm(h, params["encoder"]["final_norm"], cfg.norm_eps)

    positions = torch.arange(S, device=x.device).expand(Btok, S)
    return x, positions, enc_states


def forward_train(model: Model, params, batch, ce_chunk: int = 512):
    """Scalar loss (CE + 0.01 * MoE aux).  The decoder's and the encoder's
    group bodies run under remat; prefix layers are not wrapped, as in the
    reference."""
    cfg = model.cfg
    x, positions, enc_states = _embed_inputs(model, params, batch)
    aux_total = 0.0
    for i, spec in enumerate(model.prefix_specs):
        x, _, a = B.layer_seq(params["prefix"][i], x, cfg, spec, positions, enc_states)
        aux_total = aux_total + a
    if model.n_groups:
        x, aux, _ = _run_groups_seq(model, params["groups"], model.group_specs, model.n_groups,
                                    x, positions, enc_states, False, remat=True)
        aux_total = aux_total + aux

    h = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        # image positions carry no next-token loss
        pad = h.shape[1] - labels.shape[1]
        labels = torch.nn.functional.pad(labels, (pad, 0), value=-100)
    loss = L.chunked_ce_loss(h, labels, _unembed(params, cfg), chunk=ce_chunk)
    return loss + 0.01 * aux_total


def _logits(params, cfg, x):
    h = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return h.float() @ _unembed(params, cfg).float()


def prefill(model: Model, params, batch):
    """Forward over the full prompt; returns (last_logits (B, V), caches)."""
    cfg = model.cfg
    x, positions, enc_states = _embed_inputs(model, params, batch)
    prefix_caches = []
    for i, spec in enumerate(model.prefix_specs):
        x, cache, _ = B.layer_seq(params["prefix"][i], x, cfg, spec, positions, enc_states,
                                  want_cache=True)
        prefix_caches.append(cache)
    group_caches = 0
    if model.n_groups:
        x, _, group_caches = _run_groups_seq(model, params["groups"], model.group_specs,
                                             model.n_groups, x, positions, enc_states, True)
    caches = {"prefix": tuple(prefix_caches), "groups": group_caches}
    return _logits(params, cfg, x[:, -1, :]), caches


def decode_step(model: Model, params, caches, tokens, pos: int):
    """One decode step. tokens (B,) int; pos (int) the write index.  The
    caches are updated in place; returns (logits (B, V), caches)."""
    cfg = model.cfg
    pos = int(pos)
    x = L.embed(tokens, params["embed"])
    for i, spec in enumerate(model.prefix_specs):
        x, _ = B.layer_decode(params["prefix"][i], x, cfg, spec, caches["prefix"][i], pos)
    for g in range(model.n_groups):
        gp, gc = group_slice(params["groups"], g), group_slice(caches["groups"], g)
        for s, spec in enumerate(model.group_specs):
            x, _ = B.layer_decode(gp[s], x, cfg, spec, gc[s], pos)
    return _logits(params, cfg, x), caches


# -------------------------------------------------------------------- caches


def init_decode_caches(model: Model, batch_size: int, cache_len: int, enc_len: int = 0,
                       device: str | torch.device | None = None):
    """Zero caches for ``decode_step``: a cache_len-slot K/V cache per
    attention layer (window + 1 slots for a sliding window), cross K/V of
    enc_len tokens, and the recurrent states.  ``device``: the card unless
    the caller names another."""
    cfg = model.cfg
    dev = resolve_device(device)
    dt = B.dtype_of(cfg)
    f32 = torch.float32

    def one(spec: B.LayerSpec, lead=()):
        def z(shape, dtype=dt):
            return torch.zeros(lead + shape, dtype=dtype, device=dev)

        KVH, dh = cfg.n_kv_heads, cfg.d_head
        if spec.kind == "attn":
            klen = cache_len if spec.window == 0 else min(cache_len, spec.window + 1)
            c = {"k": z((batch_size, KVH, klen, dh)), "v": z((batch_size, KVH, klen, dh))}
            if spec.cross:
                c["ck"] = z((batch_size, KVH, enc_len, dh))
                c["cv"] = z((batch_size, KVH, enc_len, dh))
            return c
        if spec.kind == "mamba":
            return {"conv": z((batch_size, cfg.ssm_conv - 1, cfg.d_inner)),
                    "ssm": z((batch_size, cfg.d_inner, cfg.ssm_state), f32)}
        if spec.kind == "rwkv":
            dh = cfg.d_model // cfg.n_heads
            return {"tshift": z((batch_size, cfg.d_model), f32),
                    "wkv": z((batch_size, cfg.n_heads, dh, dh), f32),
                    "cshift": z((batch_size, cfg.d_model), f32)}
        raise ValueError(spec.kind)

    prefix = tuple(one(s) for s in model.prefix_specs)
    groups = 0
    if model.n_groups:
        groups = tuple(one(s, (model.n_groups,)) for s in model.group_specs)
    return {"prefix": prefix, "groups": groups}


def load_prefill_caches(dec, pref):
    """Copy prefill caches into decode caches (in place) and return them: a
    leaf of equal shape is copied whole, a K/V leaf with fewer sequence
    slots fills the first ones; any other leaf (a prompt longer than a
    rolling window's slots) stays as it is."""
    def leaf(dc, pc):
        if not torch.is_tensor(dc):  # no groups: 0 on both sides
            return dc
        if pc.shape == dc.shape:
            dc.copy_(pc)
        elif (pc.dim() == dc.dim() and pc.shape[:-2] == dc.shape[:-2]
              and pc.shape[-1] == dc.shape[-1] and pc.shape[-2] <= dc.shape[-2]):
            dc[..., :pc.shape[-2], :].copy_(pc)
        return dc

    return tree_map(leaf, dec, pref)
