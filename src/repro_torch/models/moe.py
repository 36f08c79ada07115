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
device, so the result is deterministic on the card too.

``moe_ffn_ep`` is the reference's explicit expert-parallel schedule (a
shard_map there), as this rank's code under an active mesh; ``moe_ffn_auto``
picks it under a mesh and ``moe_ffn`` without one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as Sh


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


# ------------------------------------------------------- the EP schedule


def _gather_rows(x):
    """The DP rows of all ranks, for compute replicated over the DP axes
    (the backward keeps this rank's rows)."""
    for axis in reversed(Sh.dp_axes()):
        x = Sh._Gather.apply(x, axis, 0, False)
    return x


def _my_rows(x):
    for axis in Sh.dp_axes():
        x = Sh.chunk_of(x, axis, 0)
    return x


def moe_ffn_ep(
    p: dict,
    x: torch.Tensor,          # (T_loc, d): this rank's DP rows, replicated over 'model'
    top_k: int,
    capacity_factor: float = 1.25,
    dp_split: bool = True,    # x is this rank's DP rows (False: every rank's)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with the reference's explicit schedule, as this
    rank's code under an active mesh.  Expert weights are sharded over
    'model' (and FSDP over 'data', gathered at use):

      * router + dispatch run replicated within each DP row (token-local),
        with capacity C from the row's T_loc tokens;
      * each model rank computes only its E_loc experts for the row's local
        tokens (a trash row and column take the other pairs) -> no token
        movement at dispatch;
      * combine = one all-reduce over 'model' of the (T_loc, d) partial
        outputs in the activations' dtype; aux is averaged over the DP axes.

    Falls back to ``moe_ffn`` over the global tokens when E % n_model or
    T % dp_size is non-zero, as the reference does.  ``p``'s leaves are
    DTensors or ``Sh.Local`` shards."""
    p = Sh.localize(p)
    E = Sh.global_dim(p["router"], 1)
    n_model, dp = Sh.tp_size(), Sh.dp_size()
    T = x.shape[0] * (dp if dp_split else 1)
    if E % n_model or T % dp:
        xs = _gather_rows(x) if dp_split else x
        out, aux = moe_ffn(Sh.use_tree(p, dp_split=False), xs, top_k, capacity_factor)
        return (_my_rows(out) if dp_split else out), aux
    if not dp_split:   # every rank holds all rows: run its own, gather the outputs
        out, aux = moe_ffn_ep(p, _my_rows(x), top_k, capacity_factor)
        return _gather_rows(out), aux
    E_loc = E // n_model
    T_loc, d = x.shape
    dev = x.device

    # router + dispatch: replicated within the DP row
    probs = torch.softmax(x.float() @ Sh.use(p["router"]), dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    me = probs.mean(dim=0)
    se = gate_idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, se, torch.full((T_loc * top_k,), 1.0 / (T_loc * top_k), dtype=torch.float32,
                          device=dev))
    aux = Sh.psum_dp(E * torch.sum(me * ce)) / dp
    sw = gate_vals.reshape(-1).to(x.dtype)
    st = torch.arange(T_loc, device=dev).repeat_interleave(top_k)
    onehot = F.one_hot(se, E)
    pos = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=1)
    C = max(1, int(T_loc * top_k / E * capacity_factor))
    keep = pos < C
    slot = torch.where(keep, pos, C)

    # this model rank's experts (E_loc = the trash row)
    e_lo = Sh.coord(Sh.tp_axis()) * E_loc
    my = (se >= e_lo) & (se < e_lo + E_loc) & keep
    se_loc = torch.where(my, se - e_lo, E_loc)
    slot_loc = torch.where(my, slot, C)
    xs, sw = Sh.enter_tp(x), Sh.enter_tp(sw)
    buf = torch.zeros((E_loc + 1, C + 1, d), dtype=x.dtype, device=dev)
    buf[se_loc, slot_loc] = xs[st]
    buf = buf[:E_loc, :C]
    experts = ("local", 0)
    g = torch.bmm(buf, Sh.use(p["w_gate"], experts))
    u = torch.bmm(buf, Sh.use(p["w_up"], experts))
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, Sh.use(p["w_down"], experts))            # (E_loc, C, d)

    yp = F.pad(y, (0, 0, 0, 1, 0, 1))
    contrib = (yp[se_loc, slot_loc] * (sw * my.to(sw.dtype))[:, None]).reshape(T_loc, top_k, d)
    out = torch.zeros((T_loc, d), dtype=x.dtype, device=dev)
    for j in range(top_k):
        out = out + contrib[:, j]
    out = Sh.leave_tp(out)                                     # combine
    if "shared" in p:
        out = out + L.swiglu_ffn(p["shared"], x)
    return out, aux


def moe_ffn_auto(p, x, top_k, capacity_factor=1.25, dp_split=True):
    """The explicit-EP schedule under a mesh, ``moe_ffn`` otherwise."""
    if Sh.active():
        return moe_ffn_ep(p, x, top_k, capacity_factor, dp_split)
    return moe_ffn(p, x, top_k, capacity_factor)

