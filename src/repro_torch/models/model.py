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

Under an active mesh (``models.sharding``) the parameters (and decode
caches) are DTensors placed by their specs, and every entry point runs as
this rank's part of the sharded program on its DP rows: the embedding and
the unembedding split the vocabulary over 'model' (a rank looks up and
scores its own rows of the table), the blocks run as ``blocks`` describes,
and the loss is summed over the DP axes.  ``params_specs`` gives the
parameters as meta tensors, for the dry run.
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
from repro_torch.models import sharding as Sh
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
    """``fn`` over the leaves (tensors, ``Sh.Local`` shards) of nested dicts
    / tuples / lists."""
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


def _unbind0(t) -> list:
    return t.unbind0() if isinstance(t, Sh.Local) else t.unbind(0)


def group_slice(stacked, g: int):
    """Group ``g`` of stacked leaves, as views."""
    return tree_map(lambda t: t[g], stacked)


def _unstack(stacked, n: int) -> list:
    """The ``n`` groups of stacked leaves, as views: one ``unbind`` a leaf,
    whose backward stacks the groups' gradients once (a ``t[g]`` per group
    would add a full-size gradient per group)."""
    parts = []
    tree_map(lambda t: parts.append(_unbind0(t)), stacked)
    groups = []
    for g in range(n):
        it = iter([p[g] for p in parts])
        groups.append(tree_map(lambda _: next(it), stacked))
    return groups


# ----------------------------------------------------------------------- init


class _MetaGenerator:
    """Stands in for a generator on the meta device: ``layers.init_linear``
    allocates nothing and draws nothing for it."""
    device = torch.device("meta")


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


def params_specs(model: Model) -> dict:
    """Every parameter as a meta tensor of its shape and dtype (the dry run:
    no allocation), through ``init_params``'s own code path."""
    return init_params(model, _MetaGenerator())


# ------------------------------------------------------------------- forward


def _unembed(params, cfg):
    if cfg.tie_embeddings:
        e = params["embed"]
        if isinstance(e, Sh.Local):
            return Sh.Local(e.t.T, {a: None if d is None else 1 - d for a, d in e.dims.items()})
        return e.T
    return params["unembed"]


def _vocab_split(w, dim: int) -> bool:
    """Whether the vocabulary (dim ``dim`` of the table) splits over 'model'
    (of more than one rank)."""
    return Sh.active() and Sh.tp_size() > 1 and Sh.global_dim(w, dim) % Sh.tp_size() == 0


def _embed(tokens, table):
    """The embedding lookup; under a mesh each rank looks up the tokens in
    its rows of the vocabulary and the ranks' rows are summed (one rank
    holds each token)."""
    if not _vocab_split(table, 0):
        return L.embed(tokens, Sh.use(table))
    w = Sh.use(table, ("local", 0))
    lo = Sh.coord(Sh.tp_axis()) * w.shape[0]
    t = tokens.long() - lo
    mine = (t >= 0) & (t < w.shape[0])
    x = L.embed(t.clamp(0, w.shape[0] - 1), w) * mine[..., None].to(w.dtype)
    return Sh.leave_tp(x)


def _ce_loss(h, labels, unembed, chunk):
    """``layers.chunked_ce_loss``; under a mesh the loss of this rank's rows
    with the vocabulary split over 'model' (each rank scores its columns;
    the log-sum-exp and the gold logit are combined over the ranks),
    divided by the DP-global count of labels and summed over the DP axes."""
    if not Sh.active():
        return L.chunked_ce_loss(h, labels, unembed, chunk=chunk)
    split = _vocab_split(unembed, 1)
    if not split:
        tot, cnt = L.chunked_ce_sums(h, labels, Sh.use(unembed), chunk)
    else:
        w = Sh.use(unembed, ("local", 1))
        tp = Sh.tp_axis()
        lo = Sh.coord(tp) * w.shape[1]

        def scores(logits, ll):
            m = Sh.all_reduce(logits.detach().amax(dim=-1), tp, torch.distributed.ReduceOp.MAX)
            logz = m + torch.log(Sh.leave_tp(torch.exp(logits - m[..., None]).sum(dim=-1)))
            t = ll - lo
            mine = (t >= 0) & (t < w.shape[1])
            gold = logits.gather(-1, t.clamp(0, w.shape[1] - 1)[..., None])[..., 0]
            return logz, Sh.leave_tp(torch.where(mine, gold, 0.0))

        tot, cnt = L.chunked_ce_sums(Sh.enter_tp(h), labels, w, chunk, scores)
    cnt = Sh.all_reduce(cnt, Sh.dp_axes())
    return Sh.psum_dp(tot / torch.clamp_min(cnt, 1))


def _run_groups_seq(model, gparams, specs, n_groups, x, positions, enc_states, want_cache,
                    remat=False, dp_split=True):
    """The stacked groups in order.  ``remat`` (with grad mode on): each
    group body runs under ``torch.utils.checkpoint``, which keeps only its
    inputs and recomputes the body in the backward.  ``dp_split`` as in
    ``blocks.layer_seq``."""
    cfg = model.cfg

    def body(gp, x):
        aux = 0.0
        group_caches = []
        for s, spec in enumerate(specs):
            x, cache, a = B.layer_seq(gp[s], x, cfg, spec, positions, enc_states, want_cache,
                                      dp_split)
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


def _embed_inputs(model: Model, params, batch, dp_split=True):
    """Returns (x (B, S, d), positions (B, S), enc_states)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x = _embed(tokens, params["embed"])
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
                                  remat=True, dp_split=dp_split)
        enc_states = L.rmsnorm(h, Sh.use(params["encoder"]["final_norm"]), cfg.norm_eps)

    positions = torch.arange(S, device=x.device).expand(Btok, S)
    return Sh.constrain_act(x), positions, enc_states


def forward_train(model: Model, params, batch, ce_chunk: int = 512):
    """Scalar loss (CE + 0.01 * MoE aux).  The decoder's and the encoder's
    group bodies run under remat; prefix layers are not wrapped, as in the
    reference."""
    cfg = model.cfg
    split = True
    if Sh.active():
        params, (batch, split) = Sh.localize(params), Sh.batch_local(batch)
    x, positions, enc_states = _embed_inputs(model, params, batch, split)
    aux_total = 0.0
    for i, spec in enumerate(model.prefix_specs):
        x, _, a = B.layer_seq(params["prefix"][i], x, cfg, spec, positions, enc_states,
                              dp_split=split)
        aux_total = aux_total + a
    if model.n_groups:
        x, aux, _ = _run_groups_seq(model, params["groups"], model.group_specs, model.n_groups,
                                    x, positions, enc_states, False, remat=True, dp_split=split)
        aux_total = aux_total + aux

    h = L.rmsnorm(x, Sh.use(params["final_norm"]), cfg.norm_eps)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        # image positions carry no next-token loss
        pad = h.shape[1] - labels.shape[1]
        labels = torch.nn.functional.pad(labels, (pad, 0), value=-100)
    loss = _ce_loss(h, labels, _unembed(params, cfg), ce_chunk)
    return loss + 0.01 * aux_total


def _logits(params, cfg, x):
    """fp32 logits (B, V); under a mesh each rank scores its columns of the
    vocabulary and the columns are gathered over 'model'."""
    h = L.rmsnorm(x, Sh.use(params["final_norm"]), cfg.norm_eps)
    w = _unembed(params, cfg)
    if not _vocab_split(w, 1):
        return h.float() @ Sh.use(w).float()
    return Sh.all_gather(h.float() @ Sh.use(w, ("local", 1)).float(), Sh.tp_axis(), 1)


def prefill(model: Model, params, batch):
    """Forward over the full prompt; returns (last_logits (B, V), caches).
    Under a mesh: this rank's rows, and a KV cache holds its KV heads."""
    cfg = model.cfg
    split = True
    if Sh.active():
        params, (batch, split) = Sh.localize(params), Sh.batch_local(batch)
    x, positions, enc_states = _embed_inputs(model, params, batch, split)
    prefix_caches = []
    for i, spec in enumerate(model.prefix_specs):
        x, cache, _ = B.layer_seq(params["prefix"][i], x, cfg, spec, positions, enc_states,
                                  want_cache=True, dp_split=split)
        prefix_caches.append(cache)
    group_caches = 0
    if model.n_groups:
        x, _, group_caches = _run_groups_seq(model, params["groups"], model.group_specs,
                                             model.n_groups, x, positions, enc_states, True,
                                             dp_split=split)
    caches = {"prefix": tuple(prefix_caches), "groups": group_caches}
    return _logits(params, cfg, x[:, -1, :]), caches


def decode_step(model: Model, params, caches, tokens, pos: int):
    """One decode step. tokens (B,) int; pos (int) the write index.  The
    caches are updated in place; returns (logits (B, V), caches).  Under a
    mesh: this rank's rows (all rows when the batch does not split over the
    DP axes) and caches placed by ``launch.dryrun.cache_pspecs``."""
    cfg = model.cfg
    pos = int(pos)
    out_caches = caches
    split = True
    if Sh.active():
        params, caches = Sh.localize(params), Sh.localize(caches)
        tokens, split = Sh.batch_local(tokens)
    x = _embed(tokens, params["embed"])
    for i, spec in enumerate(model.prefix_specs):
        x, _ = B.layer_decode(params["prefix"][i], x, cfg, spec, caches["prefix"][i], pos,
                              split)
    for g in range(model.n_groups):
        gp, gc = group_slice(params["groups"], g), group_slice(caches["groups"], g)
        for s, spec in enumerate(model.group_specs):
            x, _ = B.layer_decode(gp[s], x, cfg, spec, gc[s], pos, split)
    return _logits(params, cfg, x), out_caches


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


def load_prefill_caches(dec, pref, model: Model | None = None):
    """Copy prefill caches into decode caches (in place) and return them: a
    leaf of equal shape is copied whole, a K/V leaf with fewer sequence
    slots fills the first ones; any other leaf (a prompt longer than a
    rolling window's slots) stays as it is.  Under a mesh (``model``
    needed): the prefill's KV heads are gathered over 'model' and each rank
    copies its part of the decode caches' placement."""
    if Sh.active():
        return _load_sharded(dec, pref, model.cfg)
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


def _load_sharded(dec, pref, cfg):
    def leaf(path, dc, pc):
        if not isinstance(dc, Sh.Local):
            return
        off = 1 if "groups" in path else 0
        if path[-1] in ("k", "v", "ck", "cv"):
            pc = Sh.kv_full(pc, cfg, off + 1)
            axes, lo = Sh.seq_split(dc, off + 2)
            slots = dc.t.shape[off + 2]
            if pc.shape[off + 2] <= slots * Sh.size(axes):
                n = max(0, min(pc.shape[off + 2] - lo, slots))
                dc.t.narrow(off + 2, 0, n).copy_(pc.narrow(off + 2, lo, n))
        else:  # recurrent states: the reference's zero handoff
            Sh.state_put(dc, pc, batch_dim=off)

    Sh.tree_map_with_path(leaf, Sh.localize(dec), pref)
    return dec
