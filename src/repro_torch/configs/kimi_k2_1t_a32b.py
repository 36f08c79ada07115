"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8 per the assignment table) d_ff=2048
vocab=163840, MoE 384 experts top-8, DeepSeek-V3-style: first layer dense
(d_ff_dense=18432), one shared expert, fine-grained routed experts.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    moe_top_k=8,
    n_shared_experts=1,
    moe_period=1,
    first_dense=1,
    d_ff_dense=18432,
)

REDUCED = ModelConfig(
    name="kimi-k2-reduced",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab_size=256,
    n_experts=8,
    moe_top_k=2,
    n_shared_experts=1,
    moe_period=1,
    first_dense=1,
    d_ff_dense=192,
)
