"""RWKV-6 "Finch" block [arXiv:2404.05892]: attention-free time mix with
data-dependent decay (the low-rank 'lora' on w), plus the squared-ReLU
channel mix.

The JAX package's forms, with each ``lax.scan`` a loop: the sequence path
runs the chunked-parallel WKV6 (chunks of 64 steps in dense (c x c) form,
the per-head (B, H, dk, dv) state carried across chunks) or the per-step
recurrence, its oracle; decode is one cell step on the carried (shift,
state).  States and decays are fp32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


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


def _projections(p, x):
    prev = _shift(x)
    r = _mix(x, prev, p["mu_r"]) @ p["w_r"]
    k = _mix(x, prev, p["mu_k"]) @ p["w_k"]
    v = _mix(x, prev, p["mu_v"]) @ p["w_v"]
    g = _mix(x, prev, p["mu_g"]) @ p["w_g"]
    xw = _mix(x, prev, p["mu_w"])
    decay = p["w_decay_base"] + (xw @ p["w_decay_a"]).float() @ p["w_decay_b"].float()
    w = torch.exp(-torch.exp(decay))                     # (B, S, D) in (0,1)
    return r, k, v, g, w


def _finish(p, y, g, x_dtype):
    y = L.rmsnorm(y.to(x_dtype), p["ln_x"])
    y = y * F.silu(g.float()).to(x_dtype)
    return y @ p["w_o"]


def time_mix_seq(p, x: torch.Tensor, n_heads: int, chunk: int = 64) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): the chunked form for S > 1."""
    if chunk and x.shape[1] > 1:
        return time_mix_seq_chunked(p, x, n_heads, chunk=chunk)
    return time_mix_seq_recurrent(p, x, n_heads)


def time_mix_seq_recurrent(p, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-step recurrence (the tests' oracle for the chunked form)."""
    B, S, D = x.shape
    H = n_heads
    dh = D // H
    r, k, v, g, w = _projections(p, x)
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
    return _finish(p, y, g, x.dtype)


def time_mix_seq_chunked(p, x: torch.Tensor, n_heads: int, chunk: int = 64) -> torch.Tensor:
    """Chunked-parallel WKV6: the recurrence unrolled WITHIN chunks of c
    steps into dense (c x c) matmul form,

        S_{t-1} = diag(a_{t-1}) S_0 + sum_{s<t} diag(a_{t-1}/a_s) k_s^T v_s
        y_t     = r_t S_{t-1} + (r_t . u (x) k_t) v_t
        with a_t = cumprod(w), rt~ = r_t (.) a_{t-1}, kt~ = k_s (.) a_s^{-1},

    cumulative decays in log space with the reference's +-30 clamp."""
    B, S, D = x.shape
    H = n_heads
    dh = D // H
    r, k, v, g, w = _projections(p, x)
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
    return _finish(p, y, g, x.dtype)


def channel_mix_seq(p, x: torch.Tensor) -> torch.Tensor:
    prev = _shift(x)
    r = torch.sigmoid((_mix(x, prev, p["mu_cr"]) @ p["cm_r"]).float()).to(x.dtype)
    k = _mix(x, prev, p["mu_ck"]) @ p["cm_k"]
    k = torch.square(F.relu(k.float())).to(x.dtype)
    return r * (k @ p["cm_v"])


# --------------------------------------------------------------------- decode


def init_rwkv_state(batch: int, d_model: int, n_heads: int, device):
    dh = d_model // n_heads
    return (
        torch.zeros((batch, d_model), dtype=torch.float32, device=device),   # time-mix shift
        torch.zeros((batch, n_heads, dh, dh), dtype=torch.float32, device=device),  # wkv
        torch.zeros((batch, d_model), dtype=torch.float32, device=device),   # channel shift
    )


def time_mix_decode(p, tshift, wkv, x, n_heads: int):
    """One-token time mix. tshift (B, D) f32, wkv (B, H, dh, dh) f32, x (B, D).
    Returns (new_tshift, new_wkv, out)."""
    B, D = x.shape
    H = n_heads
    dh = D // H
    prev = tshift.to(x.dtype)

    def mix(mu):
        return x + (prev - x) * mu.to(x.dtype)

    r = (mix(p["mu_r"]) @ p["w_r"]).reshape(B, H, dh).float()
    k = (mix(p["mu_k"]) @ p["w_k"]).reshape(B, H, dh).float()
    v = (mix(p["mu_v"]) @ p["w_v"]).reshape(B, H, dh).float()
    g = mix(p["mu_g"]) @ p["w_g"]
    decay = p["w_decay_base"] + (mix(p["mu_w"]) @ p["w_decay_a"]).float() @ p["w_decay_b"].float()
    w = torch.exp(-torch.exp(decay)).reshape(B, H, dh)
    u = p["u_bonus"][None]

    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, wkv + u[..., None] * kv)
    wkv = wkv * w[..., None] + kv
    y = L.rmsnorm(y.reshape(B, D).to(x.dtype), p["ln_x"])
    y = y * F.silu(g.float()).to(x.dtype)
    return x.float(), wkv, y @ p["w_o"]


def channel_mix_decode(p, cshift, x):
    """One-token channel mix. cshift (B, D) f32, x (B, D).
    Returns (new_cshift, out)."""
    prev = cshift.to(x.dtype)
    rc = torch.sigmoid(((x + (prev - x) * p["mu_cr"].to(x.dtype)) @ p["cm_r"]).float()).to(x.dtype)
    kc = (x + (prev - x) * p["mu_ck"].to(x.dtype)) @ p["cm_k"]
    kc = torch.square(F.relu(kc.float())).to(x.dtype)
    return x.float(), rc * (kc @ p["cm_v"])
