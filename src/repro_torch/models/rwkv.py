"""RWKV-6 "Finch" block [arXiv:2404.05892]: attention-free time mix with
data-dependent decay (the low-rank 'lora' on w), plus the squared-ReLU
channel mix.

The JAX package's forms, with each ``lax.scan`` a loop: the sequence path
runs the chunked-parallel WKV6 (chunks of 64 steps in dense (c x c) form,
the per-head (B, H, dk, dv) state carried across chunks) or the per-step
recurrence, its oracle; decode is one cell step on the carried (shift,
state).  States and decays are fp32, as in the reference.

``split`` (under a mesh, ``models.sharding``): ``p`` holds this rank's
heads (``Sharding.rwkv_local``), as the reference's specs split the
weights over 'model'.  Each input of a split product enters the split
region (its gradient summed over 'model'), ``ln_x``'s mean square is summed
over 'model', and the output projections' partial sums are summed over
'model'; the channel mix's receptance runs replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as Sh


def init_rwkv(gen: torch.Generator, d_model: int, d_ff: int, n_heads: int, dtype):
    dh = d_model // n_heads
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        # time-mix interpolation factors (token shift)
        "mu_r": full((d_model,), 0.5),
        "mu_k": full((d_model,), 0.5),
        "mu_v": full((d_model,), 0.5),
        "mu_w": full((d_model,), 0.5),
        "mu_g": full((d_model,), 0.5),
        "w_r": L.init_linear(gen, (d_model, d_model), dtype=dtype),
        "w_k": L.init_linear(gen, (d_model, d_model), dtype=dtype),
        "w_v": L.init_linear(gen, (d_model, d_model), dtype=dtype),
        "w_g": L.init_linear(gen, (d_model, d_model), dtype=dtype),
        "w_o": L.init_linear(gen, (d_model, d_model), dtype=dtype),
        # data-dependent decay: w = exp(-exp(base + lora(x)))
        "w_decay_base": full((d_model,), -2.0),
        "w_decay_a": L.init_linear(gen, (d_model, 64), dtype=dtype),
        "w_decay_b": L.init_linear(gen, (64, d_model), scale=64**-0.5, dtype=dtype),
        "u_bonus": full((n_heads, dh), 0.0),
        "ln_x": full((d_model,), 1.0),
        # channel mix
        "mu_cr": full((d_model,), 0.5),
        "mu_ck": full((d_model,), 0.5),
        "cm_r": L.init_linear(gen, (d_model, d_model), dtype=dtype),
        "cm_k": L.init_linear(gen, (d_model, d_ff), dtype=dtype),
        "cm_v": L.init_linear(gen, (d_ff, d_model), scale=d_ff**-0.5, dtype=dtype),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros at t=0). x (B, S, D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def _heads(x, H):
    B, S, D = x.shape
    return x.reshape(B, S, H, D // H)


def _projections(p, x, prev, split=False):
    """r, k, v, g and the decay w of this rank's heads; ``prev`` the
    token-shifted x."""
    def proj(mu, w):
        return Sh.enter_tp(_mix(x, prev, mu), split) @ w

    r = proj(p["mu_r"], p["w_r"])
    k = proj(p["mu_k"], p["w_k"])
    v = proj(p["mu_v"], p["w_v"])
    g = proj(p["mu_g"], p["w_g"])
    xw = _mix(x, prev, p["mu_w"])
    decay = p["w_decay_base"] + Sh.enter_tp((xw @ p["w_decay_a"]).float(),
                                            split) @ p["w_decay_b"].float()
    w = torch.exp(-torch.exp(decay))                     # (B, S, D) in (0,1)
    return r, k, v, g, w


def _heads_of(n_heads: int, split: bool) -> int:
    return n_heads // Sh.tp_size() if split else n_heads


def _norm(y, gamma, split):
    """``layers.rmsnorm`` over the model width: with the heads split, the
    squares are summed over 'model'."""
    if not split:
        return L.rmsnorm(y, gamma)
    yf = y.float()
    var = Sh.psum_tp(yf.square().sum(dim=-1, keepdim=True)) / (yf.shape[-1] * Sh.tp_size())
    return (yf * torch.rsqrt(var + 1e-5) * gamma.float()).to(y.dtype)


def _finish(p, y, g, x_dtype, split=False):
    y = _norm(y.to(x_dtype), p["ln_x"], split)
    y = y * F.silu(g.float()).to(x_dtype)
    return Sh.leave_tp(y @ p["w_o"], split)


def time_mix_seq(p, x: torch.Tensor, n_heads: int, chunk: int = 64,
                 split: bool = False) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): the chunked form for S > 1."""
    if chunk and x.shape[1] > 1:
        return time_mix_seq_chunked(p, x, n_heads, chunk=chunk, split=split)
    return time_mix_seq_recurrent(p, x, n_heads, split)


def time_mix_seq_recurrent(p, x: torch.Tensor, n_heads: int, split: bool = False) -> torch.Tensor:
    """Per-step recurrence (the tests' oracle for the chunked form)."""
    B, S, _ = x.shape
    r, k, v, g, w = _projections(p, x, _shift(x), split)
    D = r.shape[-1]                                        # this rank's heads' width
    H = _heads_of(n_heads, split)
    dh = D // H
    rh = _heads(r, H).float()
    kh = _heads(k, H).float()
    vh = _heads(v, H).float()
    wh = _heads(w.to(x.dtype), H).float()
    u = p["u_bonus"][None]                                 # (1, H, dh)

    state = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]     # (B, H, dk, dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", rh[:, t], state + u[..., None] * kv))
        state = state * wh[:, t, :, :, None] + kv
    y = torch.stack(ys, dim=1).reshape(B, S, D)
    return _finish(p, y, g, x.dtype, split)


def time_mix_seq_chunked(p, x: torch.Tensor, n_heads: int, chunk: int = 64,
                         split: bool = False) -> torch.Tensor:
    """Chunked-parallel WKV6: the recurrence unrolled WITHIN chunks of c
    steps into dense (c x c) matmul form,

        S_{t-1} = diag(a_{t-1}) S_0 + sum_{s<t} diag(a_{t-1}/a_s) k_s^T v_s
        y_t     = r_t S_{t-1} + (r_t . u (x) k_t) v_t
        with a_t = cumprod(w), rt~ = r_t (.) a_{t-1}, kt~ = k_s (.) a_s^{-1},

    cumulative decays in log space with the reference's +-30 clamp."""
    B, S, _ = x.shape
    r, k, v, g, w = _projections(p, x, _shift(x), split)
    D = r.shape[-1]
    H = _heads_of(n_heads, split)
    dh = D // H
    pad = (-S) % chunk

    def pad_heads(a, fill=0.0):
        a = F.pad(_heads(a, H).float(), (0, 0, 0, 0, 0, pad), value=fill)
        return a.transpose(1, 2)                           # (B, H, Sp, dh)

    rh, kh, vh = pad_heads(r), pad_heads(k), pad_heads(v)
    wh = pad_heads(w.to(x.dtype), fill=1.0)
    u = p["u_bonus"][None]                                 # (1, H, dh)
    CL = 30.0
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device), diagonal=-1)

    S0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    ys = []
    for s in range(0, S + pad, chunk):
        rt, kt, vt, wt = (a[:, :, s:s + chunk] for a in (rh, kh, vh, wh))  # (B, H, c, dh)
        logw = torch.log(torch.clamp_min(wt, 1e-38))
        Lw = torch.cumsum(logw, dim=2)                     # inclusive cumsum
        a_excl = torch.exp(torch.clamp(Lw - logw, -CL, CL))  # a_{t-1}
        inv_a = torch.exp(torch.clamp(-Lw, -CL, CL))
        r_t = rt * a_excl
        k_t = kt * inv_a

        scores = torch.einsum("bhtd,bhsd->bhts", r_t, k_t)  # (B, H, c, c)
        y_intra = torch.einsum("bhts,bhsv->bhtv", torch.where(mask, scores, 0.0), vt)
        y_state = torch.einsum("bhtd,bhdv->bhtv", r_t, S0)
        y_diag = torch.sum(rt * u[..., None, :] * kt, dim=-1, keepdim=True) * vt
        ys.append(y_intra + y_state + y_diag)              # (B, H, c, dh)

        a_end = torch.exp(torch.clamp(Lw[:, :, -1:, :], -CL, CL))  # (B, H, 1, dh)
        decay_to_end = torch.exp(torch.clamp(Lw[:, :, -1:, :] - Lw, -CL, CL))
        S0 = a_end[:, :, 0, :, None] * S0 + torch.einsum(
            "bhsd,bhsv->bhdv", kt * decay_to_end, vt)
    y = torch.cat(ys, dim=2)[:, :, :S].transpose(1, 2).reshape(B, S, D)
    return _finish(p, y, g, x.dtype, split)


def _channel_mix(p, x, prev, split):
    r = torch.sigmoid((_mix(x, prev, p["mu_cr"]) @ p["cm_r"]).float()).to(x.dtype)
    k = Sh.enter_tp(_mix(x, prev, p["mu_ck"]), split) @ p["cm_k"]
    k = torch.square(F.relu(k.float())).to(x.dtype)
    return r * Sh.leave_tp(k @ p["cm_v"], split)


def channel_mix_seq(p, x: torch.Tensor, split: bool = False) -> torch.Tensor:
    return _channel_mix(p, x, _shift(x), split)


# --------------------------------------------------------------------- decode


def init_rwkv_state(batch: int, d_model: int, n_heads: int, device):
    dh = d_model // n_heads
    return (
        torch.zeros((batch, d_model), dtype=torch.float32, device=device),   # time-mix shift
        torch.zeros((batch, n_heads, dh, dh), dtype=torch.float32, device=device),  # wkv
        torch.zeros((batch, d_model), dtype=torch.float32, device=device),   # channel shift
    )


def time_mix_decode(p, tshift, wkv, x, n_heads: int, split: bool = False):
    """One-token time mix. tshift (B, D) f32, wkv (B, H, dh, dh) f32, x (B, D).
    Returns (new_tshift, new_wkv, out).  ``split``: ``p`` and ``wkv`` hold
    this rank's heads."""
    B = x.shape[0]
    H = _heads_of(n_heads, split)
    r, k, v, g, w = _projections(p, x, tshift.to(x.dtype), split)
    r, k, v, w = (a.reshape(B, H, -1).float() for a in (r, k, v, w))
    u = p["u_bonus"][None]

    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, wkv + u[..., None] * kv)
    wkv = wkv * w[..., None] + kv
    return x.float(), wkv, _finish(p, y.reshape(B, -1), g, x.dtype, split)


def channel_mix_decode(p, cshift, x, split: bool = False):
    """One-token channel mix. cshift (B, D) f32, x (B, D).
    Returns (new_cshift, out)."""
    return x.float(), _channel_mix(p, x, cshift.to(x.dtype), split)
