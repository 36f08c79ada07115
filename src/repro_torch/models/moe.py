"""Capacity-based top-k MoE with cumsum dispatch (GShard/Switch lineage).

The JAX package's dispatch, op for op: top-k routing with ties broken by the
lower expert index (``jax.lax.top_k``'s order; ``torch.topk`` promises
none), an exclusive cumsum over the (T*k, E) one-hot for each pair's
position within its expert, a static capacity C with overflow pairs written
to a trash column, the experts as batched (E, C, d) products, and the
combine.  Overflowed tokens (pos >= C) are dropped.

The combine sums each token's k pairs in pair order, in the activations'
dtype, which is the order the reference's ``.at[st].add`` scatter takes; it
is a loop over the k slots of a (T, k, d) view, with no atomics on either
device, so the result is deterministic on the card too.  The expert-parallel
path (``moe_ffn_ep``, a shard_map in the reference) and ``moe_ffn_auto``,
which picks it under a mesh, wait for the mesh: without one the reference's
``moe_ffn_auto`` is ``moe_ffn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             n_shared: int, dtype):
    p = {
        "router": L.init_linear(gen, (d_model, n_experts), dtype=torch.float32),
        "w_gate": L.init_linear(gen, (n_experts, d_model, d_ff), dtype=dtype),
        "w_up": L.init_linear(gen, (n_experts, d_model, d_ff), dtype=dtype),
        "w_down": L.init_linear(gen, (n_experts, d_ff, d_model), scale=d_ff**-0.5, dtype=dtype),
    }
    if n_shared:
        p["shared"] = {
            "w_gate": L.init_linear(gen, (d_model, n_shared * d_ff), dtype=dtype),
            "w_up": L.init_linear(gen, (d_model, n_shared * d_ff), dtype=dtype),
            "w_down": L.init_linear(gen, (n_shared * d_ff, d_model), scale=d_ff**-0.5,
                                    dtype=dtype),
        }
    return p


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, descending, ties broken by the lower
    index (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(
    p: dict,
    x: torch.Tensor,          # (T, d) flattened tokens
    top_k: int,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (T, d), aux_loss ()). Aux = load-balance loss (Switch)."""
    T, d = x.shape
    E = p["router"].shape[1]
    dev = x.device
    probs = torch.softmax(x.float() @ p["router"], dim=-1)   # (T, E)
    gate_vals, gate_idx = _top_k(probs, top_k)                # (T, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # ---- load-balance aux loss (Switch Transformer eq. 4); every pair adds
    # the same value, so the sum does not depend on the order of the adds
    me = probs.mean(dim=0)
    se = gate_idx.reshape(-1)                                 # (T*k,) expert ids
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, se, torch.full((T * top_k,), 1.0 / (T * top_k), dtype=torch.float32, device=dev))
    aux = E * torch.sum(me * ce)

    # ---- cumsum dispatch: position within expert from an exclusive cumsum
    sw = gate_vals.reshape(-1).to(x.dtype)
    st = torch.arange(T, device=dev).repeat_interleave(top_k)  # token of each pair
    onehot = F.one_hot(se, E)                                 # (T*k, E) int64
    pos = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=1)    # (T*k,)
    C = max(1, int(T * top_k / E * capacity_factor))
    keep = pos < C
    slot = torch.where(keep, pos, C)                          # overflow -> trash col

    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=dev)
    buf[se, slot] = x[st]
    buf = buf[:, :C]                                          # (E, C, d)

    # ---- expert FFN (real FLOPs only)
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, p["w_down"])                             # (E, C, d)

    # ---- combine: token t's pairs are rows t*k .. t*k+k-1 of contrib
    yp = F.pad(y, (0, 0, 0, 1))                               # trash col back
    contrib = (yp[se, slot] * (sw * keep.to(sw.dtype))[:, None]).reshape(T, top_k, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=dev)
    for j in range(top_k):
        out = out + contrib[:, j]

    if "shared" in p:
        out = out + L.swiglu(x, p["shared"]["w_gate"], p["shared"]["w_up"],
                             p["shared"]["w_down"])
    return out, aux

