from repro_torch.kernels.int4_dist.ops import int4_dist2  # noqa: F401
