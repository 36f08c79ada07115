"""Per-layer blocks: init + sequence apply (prefill / train forward) +
decode apply.

A layer is described by a LayerSpec (static): kind (attn|mamba|rwkv),
sliding window, MoE-ness, cross-attention.  model.py stacks layers into
groups.  Decode writes the new token's K/V, and the recurrent states, into
the cache tensors in place (the reference returns updated copies), the
rolling-window index of sliding-window layers included.

Under an active mesh (``models.sharding``) a layer runs as this rank's part
of the sharded step: its weights are gathered at use (FSDP over the DP
axes), attention splits its heads and the dense FFN its columns over
'model' (Megatron TP, one all-reduce each), the MoE runs ``moe_ffn_ep``,
mamba splits its d_inner channels and rwkv its heads over 'model' as the
weights' specs do (``Sh.channel_split``; else they run replicated).
Decode reads caches sharded by ``launch.dryrun.cache_pspecs``: a KV cache
whose sequence is split combines the ranks' softmax partials, and a
recurrent state is read and written as this rank's channels.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models import rwkv as R
from repro_torch.models import sharding as Sh
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str            # attn | mamba | rwkv
    window: int          # 0 = global
    is_moe: bool
    cross: bool = False  # decoder cross-attention (whisper)
    causal: bool = True  # False for encoder self-attention

    @staticmethod
    def of(cfg: ModelConfig, i: int) -> "LayerSpec":
        return LayerSpec(
            kind=cfg.layer_kind(i),
            window=cfg.layer_window(i),
            is_moe=cfg.layer_is_moe(i),
            cross=cfg.cross_attention,
        )


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------- init


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    d, H, KVH, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": L.init_linear(gen, (d, H * dh), dtype=dt),
        "wk": L.init_linear(gen, (d, KVH * dh), dtype=dt),
        "wv": L.init_linear(gen, (d, KVH * dh), dtype=dt),
        "wo": L.init_linear(gen, (H * dh, d), scale=(H * dh) ** -0.5, dtype=dt),
    }


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec):
    dt = dtype_of(cfg)
    d = cfg.d_model

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=gen.device)

    p: dict = {"norm1": ones()}
    if spec.kind == "attn":
        p["attn"] = init_attention(gen, cfg)
    elif spec.kind == "mamba":
        p["mamba"] = M.init_mamba(gen, d, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                                  cfg.ssm_conv, dt)
    elif spec.kind == "rwkv":
        p["rwkv"] = R.init_rwkv(gen, d, cfg.d_ff, cfg.n_heads, dt)
        return p  # rwkv block: time mix + channel mix only
    else:
        raise ValueError(spec.kind)

    if spec.cross:
        p["norm_x"] = ones()
        p["cross"] = init_attention(gen, cfg)

    p["norm2"] = ones()
    if spec.is_moe:
        p["moe"] = MoE.init_moe(gen, d, cfg.d_ff, cfg.n_experts, cfg.n_shared_experts, dt)
    else:
        dff = cfg.d_ff_dense or cfg.d_ff
        p["ffn"] = {
            "w_gate": L.init_linear(gen, (d, dff), dtype=dt),
            "w_up": L.init_linear(gen, (d, dff), dtype=dt),
            "w_down": L.init_linear(gen, (dff, d), scale=dff**-0.5, dtype=dt),
        }
    return p


# ------------------------------------------------------------------ seq apply


def _attn_seq(p, x, cfg, window, positions, kv_override=None, causal=True):
    """Heads from the weights' widths: all of them, or a rank's share under
    a mesh."""
    B, S, _ = x.shape
    dh = cfg.d_head
    H, KVH = p["wq"].shape[1] // dh, p["wk"].shape[1] // dh
    q = (x @ p["wq"]).reshape(B, S, H, dh).transpose(1, 2)
    if kv_override is None:
        k = (x @ p["wk"]).reshape(B, S, KVH, dh).transpose(1, 2)
        v = (x @ p["wv"]).reshape(B, S, KVH, dh).transpose(1, 2)
        if causal:  # rope only on the decoder path (whisper's encoder uses none)
            q = L.rope(q, positions[:, None, :], cfg.rope_theta)
            k = L.rope(k, positions[:, None, :], cfg.rope_theta)
    else:
        # cross-attention: kv from the encoder sequence (no rope, bidirectional)
        k, v = kv_override
        causal = False
    out = L.chunked_attention(q, k, v, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(B, S, H * dh)
    return out @ p["wo"], (k, v)


def cross_kv(p_attn, enc_states, cfg):
    """Project encoder states to this layer's cross K/V: (B, KVH, T, dh)."""
    B, T, _ = enc_states.shape
    dh = cfg.d_head
    KVH = p_attn["wk"].shape[1] // dh
    k = (enc_states @ p_attn["wk"]).reshape(B, T, KVH, dh)
    v = (enc_states @ p_attn["wv"]).reshape(B, T, KVH, dh)
    return k.transpose(1, 2), v.transpose(1, 2)


def _ffn_or_moe(p, x, cfg, spec, dp_split):
    if spec.is_moe:
        B, S, d = x.shape
        out, aux = MoE.moe_ffn_auto(p["moe"], x.reshape(B * S, d), cfg.moe_top_k,
                                    cfg.capacity_factor, dp_split)
        return out.reshape(B, S, d), aux
    return L.swiglu_ffn(p["ffn"], x), 0.0


def _attn_block(p, x, cfg, window, positions, causal=True, kv_override=None):
    """Attention (self, or cross with ``kv_override`` = the encoder states)
    on normalized ``x``: (out, (k, v)).  Under a mesh a rank runs its query
    heads and their KV heads and the ranks' outputs are summed, when the
    heads split (``Sh.head_split``); else every rank runs all heads."""
    if not Sh.active():
        kv = None if kv_override is None else cross_kv(p, kv_override, cfg)
        return _attn_seq(p, x, cfg, window, positions, kv_override=kv, causal=causal)
    split = Sh.head_split(cfg)
    pl = Sh.attn_local(p, cfg, split)
    x = Sh.enter_tp(x, split is not None)
    kv = None
    if kv_override is not None:
        kv = cross_kv(pl, Sh.enter_tp(kv_override, split is not None), cfg)
    out, (k, v) = _attn_seq(pl, x, cfg, window, positions, kv_override=kv, causal=causal)
    return Sh.leave_tp(out, split is not None), (k, v)


def layer_seq(p, x, cfg: ModelConfig, spec: LayerSpec, positions, enc_states=None,
              want_cache=False, dp_split=True):
    """x (B, S, d) -> (x, cache, aux). cache=None unless want_cache.
    ``dp_split`` (under a mesh): x holds this rank's DP rows, not every
    rank's."""
    aux = 0.0
    cache = None
    x = Sh.constrain_act(x)  # anchor the residual-stream layout (Megatron DP)
    norm = {k: Sh.use(p[k]) for k in ("norm1", "norm_x", "norm2") if k in p}
    if spec.kind == "attn":
        h, (k, v) = _attn_block(p["attn"], L.rmsnorm(x, norm["norm1"], cfg.norm_eps), cfg,
                                spec.window, positions, causal=spec.causal)
        x = x + h
        if want_cache:
            cache = {"k": k, "v": v}
        if spec.cross:
            if enc_states is None:
                raise ValueError("layer_seq: a cross-attention layer needs enc_states")
            hx, (ck, cv) = _attn_block(p["cross"], L.rmsnorm(x, norm["norm_x"], cfg.norm_eps),
                                       cfg, 0, positions, kv_override=enc_states)
            x = x + hx
            if want_cache:
                cache = dict(cache or {}, ck=ck, cv=cv)
        h, aux = _ffn_or_moe(p, L.rmsnorm(x, norm["norm2"], cfg.norm_eps), cfg, spec,
                             dp_split)
        x = Sh.constrain_act(x + h)
    elif spec.kind == "mamba":
        split = Sh.channel_split(cfg.d_inner)
        x = x + M.mamba_seq(Sh.mamba_local(p["mamba"], split),
                            L.rmsnorm(x, norm["norm1"], cfg.norm_eps), split=split)
        if want_cache:
            # the reference hands back ZERO recurrent state at the
            # prefill->decode handoff (not the state the scan ended in)
            B = x.shape[0]
            cache = {
                "conv": x.new_zeros((B, cfg.ssm_conv - 1, cfg.d_inner)),
                "ssm": x.new_zeros((B, cfg.d_inner, cfg.ssm_state), dtype=torch.float32),
            }
        h, aux = _ffn_or_moe(p, L.rmsnorm(x, norm["norm2"], cfg.norm_eps), cfg, spec,
                             dp_split)
        x = Sh.constrain_act(x + h)
    elif spec.kind == "rwkv":
        split = Sh.channel_split(cfg.n_heads)
        pr = Sh.rwkv_local(p["rwkv"], split)
        x = x + R.time_mix_seq(pr, x, cfg.n_heads, split=split)
        x = x + R.channel_mix_seq(pr, x, split)
        if want_cache:  # zero state at the handoff, as in the reference
            B, D = x.shape[0], cfg.d_model
            dh = D // cfg.n_heads
            f32 = dict(dtype=torch.float32)
            cache = {
                "tshift": x.new_zeros((B, D), **f32),
                "wkv": x.new_zeros((B, cfg.n_heads, dh, dh), **f32),
                "cshift": x.new_zeros((B, D), **f32),
            }
    return x, cache, aux


# --------------------------------------------------------------- decode apply


def _attn_decode(p, x, cfg, window, cache, pos: int):
    """x (B, d); cache k/v (B, KVH, S, dh), into which the new token is
    written at ``pos`` (in place).  Under a mesh the projections run
    replicated over 'model' and each rank attends over its part of a
    sequence-split cache (``Sh.decode_attention``)."""
    B, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    k_cache, v_cache = Sh.local_t(cache["k"]), Sh.local_t(cache["v"])
    S_loc = k_cache.shape[2]
    seq_axes, lo = Sh.seq_split(cache["k"], 2)
    klen = S_loc * Sh.size(seq_axes)
    q = (x @ p["wq"]).reshape(B, H, dh)
    k_new = (x @ p["wk"]).reshape(B, KVH, dh)
    v_new = (x @ p["wv"]).reshape(B, KVH, dh)
    posb = torch.full((B, 1), pos, device=x.device)
    q = L.rope(q[:, :, None, :], posb[:, None, :], cfg.rope_theta)[:, :, 0, :]
    k_new = L.rope(k_new[:, :, None, :], posb[:, None, :], cfg.rope_theta)[:, :, 0, :]
    # Sliding-window layers use a ROLLING cache of klen <= window+1 slots:
    # the write index wraps; once full, every slot is a valid in-window key.
    # Before the wrap, context_len=pos+1 masks unwritten slots; after it, all
    # klen slots are in-window by construction (RoPE carries absolute
    # positions and softmax is order-invariant).
    write_idx = pos % klen if window > 0 else pos
    if lo <= write_idx < lo + S_loc:
        k_cache[:, :, write_idx - lo] = k_new
        v_cache[:, :, write_idx - lo] = v_new
    out = _cached_attention(q, k_cache, v_cache, min(pos + 1, klen), seq_axes, lo)
    return out.reshape(B, H * dh) @ p["wo"]


def _cached_attention(q, k, v, context_len: int, seq_axes, lo: int):
    """Decode attention over this rank's part of a cache whose sequence the
    axes ``seq_axes`` split (none: the whole cache)."""
    if seq_axes:
        return Sh.decode_attention(q, k, v, context_len, lo, seq_axes)
    return L.decode_attention(q, k, v, context_len=context_len)


def _cross_decode(p, x, cfg, ck, cv):
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, H, dh)
    seq_axes, lo = Sh.seq_split(ck, 2)
    ck, cv = Sh.local_t(ck), Sh.local_t(cv)
    out = _cached_attention(q, ck, cv, ck.shape[2] * Sh.size(seq_axes), seq_axes, lo)
    return out.reshape(B, H * dh) @ p["wo"]


def _ffn_decode(p, x, cfg, spec, norm2, dp_split):
    xf = L.rmsnorm(x, norm2, cfg.norm_eps)
    if spec.is_moe:
        return MoE.moe_ffn_auto(p["moe"], xf, cfg.moe_top_k, cfg.capacity_factor, dp_split)
    return L.swiglu_ffn(p["ffn"], xf[:, None, :])[:, 0], 0.0


def layer_decode(p, x, cfg: ModelConfig, spec: LayerSpec, cache: dict, pos: int,
                 dp_split=True):
    """x (B, d) one token -> (x, aux); ``cache`` (this layer's dict) is
    updated in place.  Cross K/V come from the cache (computed once at
    prefill).  ``dp_split`` as in ``layer_seq``."""
    aux = 0.0
    norm = {k: Sh.use(p[k]) for k in ("norm1", "norm_x", "norm2") if k in p}
    if spec.kind == "attn":
        x = x + _attn_decode(Sh.use_tree(p["attn"]), L.rmsnorm(x, norm["norm1"], cfg.norm_eps),
                             cfg, spec.window, cache, pos)
        if spec.cross:
            xq = L.rmsnorm(x, norm["norm_x"], cfg.norm_eps)
            x = x + _cross_decode(Sh.use_tree(p["cross"]), xq, cfg, cache["ck"], cache["cv"])
        h, aux = _ffn_decode(p, x, cfg, spec, norm["norm2"], dp_split)
        x = x + h
    elif spec.kind == "mamba":
        split = Sh.channel_split(cfg.d_inner)
        dims = {"conv": 2 if split else None, "ssm": 1 if split else None}
        state = [Sh.state_part(cache[k], d) for k, d in dims.items()]
        new, h = M.mamba_decode(Sh.mamba_local(p["mamba"], split), state,
                                L.rmsnorm(x, norm["norm1"], cfg.norm_eps), split)
        for (k, d), t in zip(dims.items(), new):
            Sh.state_put_part(cache[k], t, d)
        x = x + h
        h, aux = _ffn_decode(p, x, cfg, spec, norm["norm2"], dp_split)
        x = x + h
    elif spec.kind == "rwkv":
        split = Sh.channel_split(cfg.n_heads)
        pr = Sh.rwkv_local(p["rwkv"], split)
        heads = 1 if split else None
        ts, wkv, out = R.time_mix_decode(pr, Sh.state_full(cache["tshift"]),
                                         Sh.state_part(cache["wkv"], heads), x, cfg.n_heads,
                                         split)
        x = x + out
        cs, out2 = R.channel_mix_decode(pr, Sh.state_full(cache["cshift"]), x, split)
        x = x + out2
        Sh.state_put(cache["tshift"], ts)
        Sh.state_put_part(cache["wkv"], wkv, heads)
        Sh.state_put(cache["cshift"], cs)
    return x, aux
