"""Mamba-1 selective SSM block (jamba's recurrent layer) [arXiv:2312.00752].

The JAX package's forms, with each ``lax.scan`` a loop: the sequence path
runs the chunked selective scan (log-space cumulative decays within chunks
of ``chunk`` steps, state carried across chunks) or the per-step
recurrence, its oracle; decode is the same cell applied once to the carried
(conv_state, ssm_state).  The state is fp32 throughout.

``split`` (under a mesh, ``models.sharding``): ``p`` holds this rank's
chunk of the d_inner channels (``Sharding.mamba_local``), as the
reference's specs split them over 'model'.  The input enters the split
region (its gradient summed over 'model'), the three products that
contract the channels (dt's low rank, B, C) are summed over 'model', and
the output projection's partial sums are summed over 'model'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as Sh


def init_mamba(gen: torch.Generator, d_model: int, d_inner: int, N: int, dt_rank: int,
               K: int, dtype):
    dev = gen.device
    return {
        "in_proj": L.init_linear(gen, (d_model, 2 * d_inner), dtype=dtype),
        "conv_w": L.init_linear(gen, (K, d_inner), scale=K**-0.5, dtype=dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_dt1": L.init_linear(gen, (d_inner, dt_rank), dtype=dtype),
        "w_dt2": L.init_linear(gen, (dt_rank, d_inner), scale=dt_rank**-0.5, dtype=dtype),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=torch.float32, device=dev),
        "w_B": L.init_linear(gen, (d_inner, N), dtype=dtype),
        "w_C": L.init_linear(gen, (d_inner, N), dtype=dtype),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)
                           [None, :].repeat(d_inner, 1)),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": L.init_linear(gen, (d_inner, d_model), scale=d_inner**-0.5, dtype=dtype),
    }


def _cell(p, h, x_t, dt_t, B_t, C_t):
    """One recurrence step. h (B, di, N); x_t, dt_t (B, di); B_t, C_t (B, N)."""
    A = -torch.exp(p["A_log"])                            # (di, N)
    dA = torch.exp(dt_t[..., None] * A[None])             # (B, di, N)
    dBx = dt_t[..., None] * x_t[..., None] * B_t[:, None, :]
    h = h * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, C_t)
    return h, y


def _pre(p, x):
    """x (B, S, d_model) -> (x1, z), each (B, S, di)."""
    x1, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    return x1, z


def _conv_scan_inputs(p, x1, split=False):
    S = x1.shape[1]
    K = p["conv_w"].shape[0]
    xp = F.pad(x1, (0, 0, K - 1, 0))
    xc = sum(xp[:, i:i + S, :] * p["conv_w"][i][None, None, :] for i in range(K)) + p["conv_b"]
    xc = F.silu(xc.float()).to(x1.dtype)
    dt, Bm, Cm = _low_rank(p, xc, split)
    return xc, dt, Bm, Cm


def _low_rank(p, xc, split):
    """dt (through its low rank), B and C of the conv output ``xc``: each
    product over the channels summed over 'model' when they split."""
    dt = F.softplus(Sh.psum_tp(xc @ p["w_dt1"], split) @ p["w_dt2"] + p["dt_bias"]).float()
    Bm = Sh.psum_tp(xc @ p["w_B"], split).float()
    Cm = Sh.psum_tp(xc @ p["w_C"], split).float()
    return dt, Bm, Cm


def _out(p, x, y, xc, z, split=False):
    y = y.to(x.dtype) + p["D"].to(x.dtype) * xc
    y = y * F.silu(z.float()).to(x.dtype)
    return Sh.leave_tp(y @ p["out_proj"], split)


def mamba_seq(p, x: torch.Tensor, chunk: int = 32, split: bool = False) -> torch.Tensor:
    """Training/prefill path. x (B, S, d_model) -> (B, S, d_model): the
    chunked form for S > 1."""
    if chunk and x.shape[1] > 1:
        return mamba_seq_chunked(p, x, chunk=chunk, split=split)
    return mamba_seq_recurrent(p, x, split)


def mamba_seq_recurrent(p, x: torch.Tensor, split: bool = False) -> torch.Tensor:
    """Per-step recurrence (the tests' oracle for the chunked form)."""
    B, S, _ = x.shape
    N = p["w_B"].shape[1]
    di = p["D"].shape[0]
    x1, z = _pre(p, Sh.enter_tp(x, split))
    xc, dt, Bm, Cm = _conv_scan_inputs(p, x1, split)
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h, y = _cell(p, h, xc[:, t].float(), dt[:, t], Bm[:, t], Cm[:, t])
        ys.append(y)
    return _out(p, x, torch.stack(ys, dim=1), xc, z, split)


def mamba_seq_chunked(p, x: torch.Tensor, chunk: int = 32, split: bool = False) -> torch.Tensor:
    """Chunked selective scan: the diagonal recurrence
        h_t = a_t (.) h_{t-1} + b_t,   a_t = exp(dt_t A),  b_t = dt_t x_t B_t
    unrolls within a chunk of c steps via log-space cumulative decays:
        h_t = exp(L_t) (.) [h_0 + cumsum_{s<=t} exp(-L_s) (.) b_s],
        y_t = <C_t, h_t>_N
    with the +-30 clamp of the reference."""
    B, S, _ = x.shape
    N = p["w_B"].shape[1]
    di = p["D"].shape[0]
    x1, z = _pre(p, Sh.enter_tp(x, split))
    xc, dt, Bm, Cm = _conv_scan_inputs(p, x1, split)

    pad = (-S) % chunk
    xcf = F.pad(xc.float(), (0, 0, 0, pad))
    dtf = F.pad(dt, (0, 0, 0, pad))
    Bf = F.pad(Bm, (0, 0, 0, pad))
    Cf = F.pad(Cm, (0, 0, 0, pad))
    A = -torch.exp(p["A_log"])                            # (di, N)
    CL = 30.0

    h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for s in range(0, S + pad, chunk):
        xck, dtk = xcf[:, s:s + chunk], dtf[:, s:s + chunk]
        Bk, Ck = Bf[:, s:s + chunk], Cf[:, s:s + chunk]
        # log decays: L_t = sum_{s<=t} dt_s A   (all negative)
        L_ = torch.cumsum(dtk[..., None] * A[None, None], dim=1)   # (B, c, di, N)
        b = dtk[..., None] * xck[..., None] * Bk[:, :, None, :]
        inner = torch.cumsum(torch.exp(torch.clamp(-L_, -CL, CL)) * b, dim=1)
        h = torch.exp(torch.clamp(L_, -CL, CL)) * (h0[:, None] + inner)
        ys.append(torch.einsum("bcdn,bcn->bcd", h, Ck))
        h0 = h[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    return _out(p, x, y, xc, z, split)


def mamba_decode(p, state, x, split: bool = False):
    """One-token path. state = (conv_buf (B, K-1, di), h (B, di, N)); x (B, d).
    Returns (new_state, out).  ``split``: ``p`` and the state hold this
    rank's channels."""
    conv_buf, h = state
    x1, z = (x @ p["in_proj"]).chunk(2, dim=-1)          # (B, di)
    window = torch.cat([conv_buf, x1[:, None, :]], dim=1)  # (B, K, di)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc.float()).to(x.dtype)
    dt, B_t, C_t = _low_rank(p, xc, split)
    h, y = _cell(p, h, xc.float(), dt, B_t, C_t)
    return (window[:, 1:], h), _out(p, x, y, xc, z, split)


def init_mamba_state(batch: int, d_inner: int, N: int, K: int, dtype, device):
    return (
        torch.zeros((batch, K - 1, d_inner), dtype=dtype, device=device),
        torch.zeros((batch, d_inner, N), dtype=torch.float32, device=device),
    )
