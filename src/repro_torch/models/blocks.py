"""Per-layer blocks: init + sequence apply (prefill / train forward) +
decode apply.

A layer is described by a LayerSpec (static): kind (attn|mamba|rwkv),
sliding window, MoE-ness, cross-attention.  model.py stacks layers into
groups.  Decode writes the new token's K/V, and the recurrent states, into
the cache tensors in place (the reference returns updated copies), the
rolling-window index of sliding-window layers included.  The reference's
activation-layout hints (``constrain_act``) do nothing without a mesh and
are left out.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models import rwkv as R
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
    B, S, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
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
    KVH, dh = cfg.n_kv_heads, cfg.d_head
    k = (enc_states @ p_attn["wk"]).reshape(B, T, KVH, dh)
    v = (enc_states @ p_attn["wv"]).reshape(B, T, KVH, dh)
    return k.transpose(1, 2), v.transpose(1, 2)


def _ffn_or_moe(p, x, cfg, spec):
    if spec.is_moe:
        B, S, d = x.shape
        out, aux = MoE.moe_ffn(p["moe"], x.reshape(B * S, d), cfg.moe_top_k,
                               cfg.capacity_factor)
        return out.reshape(B, S, d), aux
    return L.swiglu(x, p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"]), 0.0


def layer_seq(p, x, cfg: ModelConfig, spec: LayerSpec, positions, enc_states=None,
              want_cache=False):
    """x (B, S, d) -> (x, cache, aux). cache=None unless want_cache."""
    aux = 0.0
    cache = None
    if spec.kind == "attn":
        h, (k, v) = _attn_seq(p["attn"], L.rmsnorm(x, p["norm1"], cfg.norm_eps), cfg,
                              spec.window, positions, causal=spec.causal)
        x = x + h
        if want_cache:
            cache = {"k": k, "v": v}
        if spec.cross:
            if enc_states is None:
                raise ValueError("layer_seq: a cross-attention layer needs enc_states")
            ck, cv = cross_kv(p["cross"], enc_states, cfg)
            hx, _ = _attn_seq(p["cross"], L.rmsnorm(x, p["norm_x"], cfg.norm_eps), cfg, 0,
                              positions, kv_override=(ck, cv))
            x = x + hx
            if want_cache:
                cache = dict(cache or {}, ck=ck, cv=cv)
        h, aux = _ffn_or_moe(p, L.rmsnorm(x, p["norm2"], cfg.norm_eps), cfg, spec)
        x = x + h
    elif spec.kind == "mamba":
        x = x + M.mamba_seq(p["mamba"], L.rmsnorm(x, p["norm1"], cfg.norm_eps))
        if want_cache:
            # the reference hands back ZERO recurrent state at the
            # prefill->decode handoff (not the state the scan ended in)
            B = x.shape[0]
            cache = {
                "conv": x.new_zeros((B, cfg.ssm_conv - 1, cfg.d_inner)),
                "ssm": x.new_zeros((B, cfg.d_inner, cfg.ssm_state), dtype=torch.float32),
            }
        h, aux = _ffn_or_moe(p, L.rmsnorm(x, p["norm2"], cfg.norm_eps), cfg, spec)
        x = x + h
    elif spec.kind == "rwkv":
        x = x + R.time_mix_seq(p["rwkv"], x, cfg.n_heads)
        x = x + R.channel_mix_seq(p["rwkv"], x)
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
    written at ``pos`` (in place)."""
    B, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    klen = cache["k"].shape[2]
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
    cache["k"][:, :, write_idx] = k_new
    cache["v"][:, :, write_idx] = v_new
    out = L.decode_attention(q, cache["k"], cache["v"], context_len=min(pos + 1, klen))
    return out.reshape(B, H * dh) @ p["wo"]


def _ffn_decode(p, x, cfg, spec):
    xf = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    if spec.is_moe:
        return MoE.moe_ffn(p["moe"], xf, cfg.moe_top_k, cfg.capacity_factor)
    return L.swiglu(xf[:, None, :], p["ffn"]["w_gate"], p["ffn"]["w_up"],
                    p["ffn"]["w_down"])[:, 0], 0.0


def layer_decode(p, x, cfg: ModelConfig, spec: LayerSpec, cache: dict, pos: int):
    """x (B, d) one token -> (x, aux); ``cache`` (this layer's dict) is
    updated in place.  Cross K/V come from the cache (computed once at
    prefill)."""
    aux = 0.0
    if spec.kind == "attn":
        x = x + _attn_decode(p["attn"], L.rmsnorm(x, p["norm1"], cfg.norm_eps), cfg,
                             spec.window, cache, pos)
        if spec.cross:
            B = x.shape[0]
            H, dh = cfg.n_heads, cfg.d_head
            xq = L.rmsnorm(x, p["norm_x"], cfg.norm_eps)
            q = (xq @ p["cross"]["wq"]).reshape(B, H, dh)
            out = L.decode_attention(q, cache["ck"], cache["cv"], context_len=cache["ck"].shape[2])
            x = x + out.reshape(B, H * dh) @ p["cross"]["wo"]
        h, aux = _ffn_decode(p, x, cfg, spec)
        x = x + h
    elif spec.kind == "mamba":
        (conv, ssm), h = M.mamba_decode(p["mamba"], (cache["conv"], cache["ssm"]),
                                        L.rmsnorm(x, p["norm1"], cfg.norm_eps))
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        x = x + h
        h, aux = _ffn_decode(p, x, cfg, spec)
        x = x + h
    elif spec.kind == "rwkv":
        ts, wkv, out = R.time_mix_decode(p["rwkv"], cache["tshift"], cache["wkv"], x,
                                         cfg.n_heads)
        x = x + out
        cs, out2 = R.channel_mix_decode(p["rwkv"], cache["cshift"], x)
        x = x + out2
        for name, new in (("tshift", ts), ("wkv", wkv), ("cshift", cs)):
            cache[name].copy_(new)
    return x, aux
