"""Assigned input shapes x per-arch input specs (meta tensors), the
counterpart of the JAX package's ``launch/shapes.py``.

Shapes (assignment table):
  train_4k     seq_len=4096    global_batch=256   (training)
  prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32768   global_batch=128   (decode: 1 new token, KV=32k)
  long_500k    seq_len=524288  global_batch=1     (long-context decode)

long_500k requires sub-quadratic attention: it RUNS for rwkv6 (SSM), jamba
(hybrid: Mamba + 32k-window attention) and gemma3 (5:1 local:global; the
global-layer KV shards over the data axis), and is SKIPPED for the pure
full-attention archs (yi, granite, tinyllama, kimi, dbrx, llava) and the
enc-dec whisper (30 s source bound).  Meta tensors take the place of the
reference's ``ShapeDtypeStruct``s: a shape and a dtype, no storage.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as Mod
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

LONG_OK_FAMILIES = {"ssm", "hybrid"}
LONG_OK_ARCHS = {"gemma3-1b"}  # 5:1 local:global — dominated by O(w) layers


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if shape == "long_500k":
        if cfg.family in LONG_OK_FAMILIES or cfg.name in LONG_OK_ARCHS:
            return None
        if cfg.family == "encdec":
            return "enc-dec (whisper): 30s source bound; no 500k decode"
        return "pure full-attention arch: 500k decode requires sub-quadratic attention"
    return None


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cache_len_for(spec_window: int, seq_len: int) -> int:
    """KV slots for one layer: full layers hold seq_len; windowed layers hold a
    rolling buffer of window+1 rounded up to 128 for shardability."""
    if spec_window > 0:
        return min(_round_up(spec_window + 1, 128), _round_up(seq_len, 128))
    return seq_len


I32 = torch.int32
BF16 = torch.bfloat16


def S(shape, dtype) -> torch.Tensor:
    """A shape and a dtype: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, B: int, seq: int) -> dict:
    text = seq
    out = {}
    if cfg.frontend == "vision":
        text = max(16, seq - cfg.frontend_tokens)
        out["patches"] = S((B, cfg.frontend_tokens, cfg.d_model), BF16)
    if cfg.n_encoder_layers:
        out["frames"] = S((B, cfg.encoder_tokens, cfg.d_model), BF16)
    out["tokens"] = S((B, text), I32)
    out["labels"] = S((B, text), I32)
    return out


def decode_cache_specs(model: Mod.Model, B: int, seq_len: int):
    """Meta tensors for decode caches at the given context length."""
    cfg = model.cfg

    def one(spec, lead=()):
        if spec.kind == "attn":
            klen = cache_len_for(spec.window, seq_len)
            c = {
                "k": S(lead + (B, cfg.n_kv_heads, klen, cfg.d_head), BF16),
                "v": S(lead + (B, cfg.n_kv_heads, klen, cfg.d_head), BF16),
            }
            if spec.cross:
                c["ck"] = S(lead + (B, cfg.n_kv_heads, cfg.encoder_tokens, cfg.d_head), BF16)
                c["cv"] = S(lead + (B, cfg.n_kv_heads, cfg.encoder_tokens, cfg.d_head), BF16)
            return c
        if spec.kind == "mamba":
            return {
                "conv": S(lead + (B, cfg.ssm_conv - 1, cfg.d_inner), BF16),
                "ssm": S(lead + (B, cfg.d_inner, cfg.ssm_state), torch.float32),
            }
        if spec.kind == "rwkv":
            dh = cfg.d_model // cfg.n_heads
            return {
                "tshift": S(lead + (B, cfg.d_model), torch.float32),
                "wkv": S(lead + (B, cfg.n_heads, dh, dh), torch.float32),
                "cshift": S(lead + (B, cfg.d_model), torch.float32),
            }
        raise ValueError(spec.kind)

    prefix = tuple(one(s) for s in model.prefix_specs)
    groups = 0
    if model.n_groups:
        groups = tuple(one(s, (model.n_groups,)) for s in model.group_specs)
    return {"prefix": prefix, "groups": groups}


@dataclasses.dataclass
class CellSpec:
    kind: str                   # train | prefill | decode
    batch: dict                 # meta tensors of batch inputs
    caches: object = None       # decode only
    tokens: object = None       # decode only: (B,) int32
    pos: int = 0                # decode only: write index
    seq_len: int = 0
    global_batch: int = 0


def input_specs(cfg: ModelConfig, model: Mod.Model, shape: str) -> CellSpec:
    sh = SHAPES[shape]
    B, seq = sh["global_batch"], sh["seq_len"]
    if sh["kind"] in ("train", "prefill"):
        return CellSpec(kind=sh["kind"], batch=_batch_specs(cfg, B, seq), seq_len=seq,
                        global_batch=B)
    # decode: one new token against a KV cache of seq_len
    return CellSpec(kind="decode", batch={}, caches=decode_cache_specs(model, B, seq),
                    tokens=S((B,), I32), pos=seq - 1, seq_len=seq, global_batch=B)
