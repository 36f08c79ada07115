"""VeloANN on PyTorch and CUDA: the SSD-resident graph index served by
hand-written Hopper kernels.

Subpackages:
  core     — index build, buffer pool, coroutine engine, simulator and the
             distance plane (``core.distance.TorchEngine``)
  velo     — the HBM record-cache slot state (``velo.device_cache``)
  serving  — the paged KV pool and the cache-aware decode scheduler
  kernels  — the ``binary_ip``, ``int4_dist``, ``paged_attention`` and
             ``flash_attention`` kernels: CUDA C++ sources under ``csrc/``,
             each with its plain PyTorch version
  convert  — carries an index image or a KV pool built elsewhere into this
             package's objects

Entry points run on the CUDA card unless the caller asks for the CPU
(``core.distance.set_default_device("cpu")`` or a ``device=`` argument).
This package imports ``torch`` and ``numpy`` only.
"""
