"""Launch layer: the serving CLI (``python -m repro_torch.launch.serve``),
the training CLI (``python -m repro_torch.launch.train``) and its
fault-tolerant supervisor (``python -m repro_torch.launch.elastic``)."""
