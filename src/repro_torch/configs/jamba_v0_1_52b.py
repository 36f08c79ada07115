"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Jamba block structure: period-8 layer groups with attention at slot 4 of 8
(index 3), MoE replacing the MLP on every other layer (period 2).
Attention layers serve long contexts with a 32k sliding window (long_500k
mode; attention is full within the trained 32k at shorter shapes, which the
window reproduces exactly for seq <= 32k... window=32768).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    kind_pattern=(
        "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba"
    ),
    window_pattern=(32768,),  # rolling 32k window on the 4 attention layers
    n_experts=16,
    moe_top_k=2,
    moe_period=2,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
)

REDUCED = ModelConfig(
    name="jamba-v0.1-52b-reduced",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    kind_pattern=(
        "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba"
    ),
    window_pattern=(64,),
    n_experts=4,
    moe_top_k=2,
    moe_period=2,
    ssm_state=4,
    ssm_expand=2,
    ssm_conv=4,
)
