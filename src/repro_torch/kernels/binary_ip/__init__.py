from repro_torch.kernels.binary_ip.ops import binary_ip, estimate_dist2  # noqa: F401
