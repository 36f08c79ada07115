from repro_torch.kernels.scan_select.ops import scan_select  # noqa: F401
