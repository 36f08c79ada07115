"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone: mistral-7b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, sliding window 4096.  The vision frontend is a STUB per the
assignment: input_specs() provides precomputed anyres patch embeddings —
(2144 image tokens: 576 base + 4 tiles x 392 after pooling ~ the llava-next
token budget) already projected to d_model.
"""

from repro_torch.models.config import ModelConfig

IMAGE_TOKENS = 2144

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    window_pattern=(4096,),  # mistral sliding window
    frontend="vision",
    frontend_tokens=IMAGE_TOKENS,
)

REDUCED = ModelConfig(
    name="llava-next-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab_size=256,
    window_pattern=(32,),
    frontend="vision",
    frontend_tokens=16,
)
