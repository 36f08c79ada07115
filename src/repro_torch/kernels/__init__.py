"""Hand-written CUDA kernels, each beside its plain PyTorch version:
``binary_ip`` (level-1 sign product) and ``int4_dist`` (level-2 int4
refine) for the distance plane, ``paged_attention`` (decode through KV block
tables) for the serving plane, and ``flash_attention`` (prefill with causal
and window masks).  ``_build`` compiles ``csrc/*.cu`` at first use."""
