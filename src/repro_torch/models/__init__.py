"""The LM stack's serving path: the JAX package's ten architectures as one
composable model framework, in PyTorch.

  config.py   — ModelConfig covering dense/GQA, MoE, Mamba-hybrid, RWKV6,
                enc-dec, VLM-stub families
  layers.py   — rmsnorm, rope, swiglu, prefill attention (the flash_attention
                kernel on the card, the streaming recurrence on the CPU),
                decode attention, the chunked loss
  moe.py      — capacity-based top-k routing (cumsum dispatch, real-FLOP experts)
  mamba.py    — Mamba-1 selective SSM block (jamba's recurrent layer)
  rwkv.py     — RWKV-6 "Finch" block (data-dependent decay)
  blocks.py   — per-family layers (init + apply)
  model.py    — stacked model: init / loss / prefill / decode
"""
