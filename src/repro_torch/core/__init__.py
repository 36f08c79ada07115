"""Host plane of the port, module for module the reference's (paper §3-§4).

Submodules:
  dataset     — synthetic vector workloads + ground truth
  flat        — brute-force exact search (oracle)
  quant       — RaBitQ-style 1-bit + 4-bit two-level quantization (paper §3.3)
  codec       — delta-varint + partitioned Elias-Fano adjacency compression (§3.3)
  pages       — slotted variable-size-record page layout (§3.3, Fig. 7)
  vamana      — batched Vamana graph construction + affinity coloring (Alg. 1)
  placement   — affinity-based record co-placement (§3.4)
  store       — on-"disk" page store (the simulated SSD-resident index)
  bufferpool  — record-level buffer pool, clock second-chance (§3.2, Fig. 5)
  pagecache   — page-level LRU/FIFO/Random baselines (Table 1)
  search      — search algorithms as schedulable coroutines (Alg. 2 + baselines)
  sim         — discrete-event SSD + CPU cost model
  engine      — coroutine scheduler (paper Fig. 3) sync/async executors
  scheduling  — round-robin and SLA-aware (EDF) coroutine scheduling
  sharding    — sharded scatter-gather plane
  distance    — the batched distance plane; ``TorchEngine`` runs the CUDA kernels
  beam        — engine-resident beam state for the fused beam step
  hbm         — HBM record-cache tier above the host pool
  baselines   — DiskANN-, Starling-, PipeANN-style system configurations
"""
