"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536.  RWKV-6 heads are d_model/64 = 64.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # rwkv head size 64
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab_size=65536,
    kind_pattern=("rwkv",),
)

REDUCED = ModelConfig(
    name="rwkv6-7b-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=160,
    vocab_size=256,
    kind_pattern=("rwkv",),
)
