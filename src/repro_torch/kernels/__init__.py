"""Hand-written CUDA kernels, each beside its plain PyTorch version:
``binary_ip`` (level-1 sign product) and ``int4_dist`` (level-2 int4
refine) for the distance plane, ``paged_attention`` (decode through KV block
tables) for the serving plane, and ``flash_attention`` (prefill with causal
and window masks).  ``_build`` compiles ``csrc/*.cu`` at first use."""

# elements of the (B, rows, d) float32 temporary that the plain distance
# versions reduce at once: each (query, row) entry is its own sum over d
PAIR_CHUNK_ELEMS = 1 << 24  # 64 MB


def pair_rows(B: int, d: int) -> int:
    """Rows of a (B, rows, d) per-pair reduction that fit PAIR_CHUNK_ELEMS."""
    return max(1, PAIR_CHUNK_ELEMS // max(1, B * d))
