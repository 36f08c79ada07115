"""Shared neural layers: norms, rope, swiglu, attention, embedding, the
chunked loss and the weight init.

Prefill attention (``chunked_attention``) on CUDA tensors launches the
hand-written ``flash_attention`` kernel (``csrc/flash_attention.cu``): the
JAX package's own documents name the Pallas flash kernel as the model's
prefill path, and both compute one function (queries right-aligned to keys,
the causal and window masks, GQA by ``h // group``, an fp32 online softmax).
On CPU tensors it runs the reference's streaming recurrence over KV blocks
with its finite ``NEG_INF``.  In training (grad mode on, an input that
requires a gradient) the card's call goes through ``FlashAttention``: the
kernel's forward, and a backward that is autograd of the streaming
recurrence, recomputed from the saved q, k, v; the reference's training
backward is XLA's autodiff of that same recurrence.  Decode attention is
plain tensor ops over the dense (B, KVH, S, Dh) cache on both devices, as
in the reference.

The reference's conventions are kept: matmuls return their inputs' dtype,
silu / rmsnorm / softmax run in fp32 and cast back, q is scaled in its own
dtype before the product, indices are int64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import sharding as Sh

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, Dh); positions: broadcastable to (..., S).  Half-split
    layout, fp32 angles, cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def swiglu_ffn(p: dict, x):
    """The FFN of a weight dict (w_gate, w_up, w_down); under a mesh its
    columns split over 'model' when they divide (one all-reduce of the
    output), else it runs replicated."""
    if not Sh.active():
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    tp = Sh.global_dim(p["w_gate"], 1) % Sh.tp_size() == 0
    cols, rows = (("local", 1), ("local", 0)) if tp else (None, None)
    h = swiglu(Sh.enter_tp(x, tp), Sh.use(p["w_gate"], cols), Sh.use(p["w_up"], cols),
               Sh.use(p["w_down"], rows))
    return Sh.leave_tp(h, tp)


# --------------------------------------------------------------- attention


def _streaming_attention(q, k, v, causal: bool, window: int, block: int,
                         q_offset: int | None) -> torch.Tensor:
    """The reference's streaming recurrence over KV blocks of ``block`` keys
    (fp32 online softmax, finite ``NEG_INF``), on q's device."""
    B, H, Sq, Dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    scale = Dh**-0.5
    group = H // KVH
    q_offset = q_offset if q_offset is not None else Skv - Sq
    block = min(block, Skv)
    nb = -(-Skv // block)
    pad = nb * block - Skv
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))

    q32 = (q * scale).float()
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dh), dtype=torch.float32, device=q.device)
    for bi in range(nb):
        kk = kp[:, :, bi * block:(bi + 1) * block].repeat_interleave(group, dim=1).float()
        vv = vp[:, :, bi * block:(bi + 1) * block].repeat_interleave(group, dim=1).float()
        logits = torch.einsum("bhqd,bhkd->bhqk", q32, kk)
        k_pos = bi * block + torch.arange(block, device=q.device)
        mask = (k_pos[None, :] < Skv)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vv)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _flash(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The flash_attention kernel on q * scale (scaled in q's dtype, the
    reference's order), ``scale=1``.  ``flash_ops.flash_attention`` is
    looked up at each call, so a wrapper installed on the module sees it."""
    # the reference scales q in its own dtype before the product
    qs = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    torch.mul(q, q.shape[-1]**-0.5, out=qs)
    return flash_ops.flash_attention(qs, k.contiguous(), v.contiguous(), causal=causal,
                                     window=window if window > 0 else None, scale=1.0)


class FlashAttention(torch.autograd.Function):
    """Prefill attention with a gradient: forward by the flash_attention
    kernel (its plain version for CPU tensors), backward by autograd of the
    streaming recurrence recomputed from the saved (unscaled) q, k, v under
    ``torch.enable_grad()``.  The JAX package has no backward kernel: its
    training backward is XLA's autodiff of the same recurrence, so this is
    the reference's arithmetic.  Queries are right-aligned to the keys."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, block: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.block = causal, window, block
        return _flash(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function("chunked_attention.backward"), torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            out = _streaming_attention(*inputs, ctx.causal, ctx.window, ctx.block, None)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * 3


def chunked_attention(
    q: torch.Tensor,        # (B, H, Sq, Dh)
    k: torch.Tensor,        # (B, KVH, Skv, Dh)
    v: torch.Tensor,        # (B, KVH, Skv, Dh)
    causal: bool = True,
    window: int = 0,        # 0 = full
    block: int = 512,
    q_offset: int | None = None,  # key position of query row 0
) -> torch.Tensor:
    """Prefill attention (B, H, Sq, Dh) in q's dtype.

    CUDA tensors launch the flash_attention kernel, which aligns queries to
    the right of the keys (``q_offset = Skv - Sq``, the default and the only
    offset the model passes; another raises).  With grad mode on and an
    input that requires a gradient, the call goes through ``FlashAttention``
    (the kernel forward, the streaming recurrence's backward).  CPU tensors
    take the streaming recurrence of the reference over KV blocks of
    ``block`` keys, under autograd as it is."""
    if q.is_cuda or k.is_cuda or v.is_cuda:
        Sq, Skv = q.shape[2], k.shape[2]
        if q_offset is not None and q_offset != Skv - Sq:
            raise ValueError(f"chunked_attention: the flash kernel aligns queries to the "
                             f"right of the keys (q_offset {Skv - Sq}), got {q_offset}")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, block)
        return _flash(q, k, v, causal, window)
    return _streaming_attention(q, k, v, causal, window, block, q_offset)


def decode_attention(
    q: torch.Tensor,        # (B, H, Dh) one token
    k: torch.Tensor,        # (B, KVH, S, Dh) cache
    v: torch.Tensor,
    context_len,            # int, () or (B,) valid tokens
    window: int = 0,
) -> torch.Tensor:
    """Single-token decode attention over a dense KV cache, as plain einsum
    and softmax (each KV head's query group in one product, no repeat)."""
    B, H, Dh = q.shape
    KVH, S = k.shape[1], k.shape[2]
    group = H // KVH
    qg = (q.float() * Dh**-0.5).reshape(B, KVH, group, Dh)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float()).reshape(B, H, S)
    pos = torch.arange(S, device=q.device)[None, :]
    ctx = torch.as_tensor(context_len, device=q.device).reshape(-1, 1)
    mask = pos < ctx
    if window > 0:
        mask = mask & (pos > ctx - 1 - window)
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p.reshape(B, KVH, group, S), v.float())
    return out.reshape(B, H, Dh).to(q.dtype)


# ----------------------------------------------------------------- embedding


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def logz_gold(logits: torch.Tensor, labels: torch.Tensor):
    """Each position's log-sum-exp and logit of its label (labels < 0 read
    column 0)."""
    return (torch.logsumexp(logits, dim=-1),
            logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0])


def chunked_ce_loss(
    h: torch.Tensor,          # (B, S, D) final hidden states
    labels: torch.Tensor,     # (B, S) int, -100 = ignore
    unembed: torch.Tensor,    # (D, V)
    chunk: int = 512,
) -> torch.Tensor:
    """Cross-entropy over chunks of ``chunk`` positions, without the whole
    (B, S, V) logits at once."""
    tot, cnt = chunked_ce_sums(h, labels, unembed, chunk)
    return tot / torch.clamp_min(cnt, 1)


def chunked_ce_sums(h, labels, unembed, chunk: int = 512, scores=logz_gold):
    """(sum of the labelled positions' losses (fp32), their count), over
    chunks of ``chunk`` positions.  ``scores(logits, labels) -> (logz,
    gold)`` reads a chunk's fp32 logits (a vocabulary split over ranks
    combines the ranks' parts there)."""
    B, S, D = h.shape
    nb = -(-S // chunk)
    pad = nb * chunk - S
    hp = F.pad(h, (0, 0, 0, pad))
    lp = F.pad(labels.long(), (0, pad), value=-100)
    w = unembed.float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(nb):
        ll = lp[:, i * chunk:(i + 1) * chunk]
        logits = hp[:, i * chunk:(i + 1) * chunk].float() @ w
        logz, gold = scores(logits, ll)
        valid = ll >= 0
        tot = tot + torch.where(valid, logz - gold, 0.0).sum()
        cnt = cnt + valid.sum()
    return tot, cnt


def init_linear(gen: torch.Generator, shape, scale=None, dtype=torch.bfloat16):
    """Normal(0, scale) weights drawn from ``gen`` on its device, scale
    defaulting to ``shape[0] ** -0.5``; on the meta device nothing is
    drawn (``models.model.params_specs``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)
