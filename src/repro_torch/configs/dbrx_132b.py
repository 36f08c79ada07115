"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    moe_top_k=4,
    moe_period=1,
)

REDUCED = ModelConfig(
    name="dbrx-132b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab_size=256,
    n_experts=4,
    moe_top_k=2,
    moe_period=1,
)
