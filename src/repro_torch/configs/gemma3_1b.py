"""gemma3-1b [dense] — 5:1 local:global attention, 128k-class context
[hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
Local layers use a 512-token sliding window (gemma3 reference value for the
1b model); every 6th layer is global.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262144,
    window_pattern=(512, 512, 512, 512, 512, 0),  # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma3-1b-reduced",
    family="dense",
    n_layers=8,  # 6-layer pattern + 2 prefix remainder, like 26 = 4*6+2
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=160,
    vocab_size=512,
    window_pattern=(16, 16, 16, 16, 16, 0),
    tie_embeddings=True,
)
