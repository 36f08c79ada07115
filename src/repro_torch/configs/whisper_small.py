"""whisper-small [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

12L (x2: encoder+decoder) d_model=768 12H (kv=12, i.e. MHA) d_ff=3072
vocab=51865.  The conv frontend is a STUB per the assignment: input_specs()
provides precomputed frame embeddings (1500 frames = 30 s at the post-conv
50 Hz rate) at d_model.
"""

from repro_torch.models.config import ModelConfig

ENCODER_FRAMES = 1500

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    n_encoder_layers=12,
    encoder_tokens=ENCODER_FRAMES,
    cross_attention=True,
    frontend="audio",
)

REDUCED = ModelConfig(
    name="whisper-small-reduced",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    n_encoder_layers=2,
    encoder_tokens=30,
    cross_attention=True,
    frontend="audio",
)
