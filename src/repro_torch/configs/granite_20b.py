"""granite-20b [dense] — llama-arch MQA, code model [arXiv:2405.04324; hf].

52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576 vocab=49152.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab_size=49152,
)

REDUCED = ModelConfig(
    name="granite-20b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=192,
    vocab_size=256,
)
