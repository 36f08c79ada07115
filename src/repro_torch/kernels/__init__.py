"""Hand-written CUDA kernels for the distance plane, each beside its plain
PyTorch version: ``binary_ip`` (level-1 sign product) and ``int4_dist``
(level-2 int4 refine).  ``_build`` compiles ``csrc/*.cu`` at first use."""
