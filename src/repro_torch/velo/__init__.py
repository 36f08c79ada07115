"""Device plane of the port: the VeloANN engine whose search loop runs on
the card.

  index.py        — DeviceIndex: the compressed index as a dataclass of tensors
  batch_search.py — batched lockstep cache-aware beam search (a loop of
                    device ops, no host copy inside)
  scan_search.py  — kernel-powered two-stage scan (binary_ip tensor-core
                    sweep -> int4 rerank) with stable top-k merges
  device_cache.py — HBM record cache with record_map indirection + vectorized
                    clock second-chance (paper §3.2 on device)
  dist_search.py  — distributed search over a torch.distributed group with
                    a top-k merge
"""
