"""ModelConfig: one dataclass spanning all assigned architecture families."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # attention pattern: per-layer window sizes, cycled across layers.
    # 0 = full/global attention; w > 0 = sliding window of w.
    window_pattern: tuple[int, ...] = (0,)

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_period: int = 1          # MoE on layers where (i % period) == period-1
    first_dense: int = 0         # leading layers forced dense (kimi-k2 style)
    d_ff_dense: int | None = None  # FFN width of the dense layers when mixed
    capacity_factor: float = 1.25

    # hybrid (jamba): layer kinds cycled, e.g. ("mamba",)*7 + ("attn",)
    kind_pattern: tuple[str, ...] = ("attn",)

    # SSM
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0         # 0 -> ceil(d_model/16)

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_tokens: int = 0      # e.g. 1500 audio frames
    cross_attention: bool = False

    # modality frontend stub
    frontend: str | None = None  # "audio" | "vision"
    frontend_tokens: int = 0     # vision: image patch token count

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kind(self, i: int) -> str:
        return self.kind_pattern[i % len(self.kind_pattern)]

    def layer_window(self, i: int) -> int:
        return self.window_pattern[i % len(self.window_pattern)]

    def layer_is_moe(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense:
            return False
        return (i % self.moe_period) == (self.moe_period - 1)

    def params_count(self) -> int:
        """Total parameter count (for 6ND roofline accounting)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        o = self.n_heads * self.d_head * d
        total = 0
        layers = [("enc", i) for i in range(self.n_encoder_layers)] + [
            ("dec", i) for i in range(self.n_layers)
        ]
        for side, i in layers:
            kind = self.layer_kind(i) if side == "dec" else "attn"
            if kind == "attn":
                total += qkv + o
                if side == "dec" and self.cross_attention:
                    total += qkv + o
            elif kind == "mamba":
                di, N, dtr = self.d_inner, self.ssm_state, self.dt_rank
                total += d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * N)
                total += dtr * di + di * N + di * d  # dt proj, A? (A is di*N), out
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,o + gate (approx; exact in blocks)
                total += 2 * d * (self.d_ff // 1)  # channel-mix
            if side == "dec" and self.layer_is_moe(i):
                total += self.n_experts * 3 * d * dff
                total += self.n_shared_experts * 3 * d * dff
                total += d * self.n_experts  # router
            elif kind in ("attn", "mamba"):
                dffd = self.d_ff_dense or dff
                total += 3 * d * dffd
        total += V * d * (1 if self.tie_embeddings else 2)
        return total

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.n_experts == 0:
            return self.params_count()
        d, dff = self.d_model, self.d_ff
        total = self.params_count()
        n_moe = sum(1 for i in range(self.n_layers) if self.layer_is_moe(i))
        total -= n_moe * (self.n_experts - self.moe_top_k) * 3 * d * dff
        return total
