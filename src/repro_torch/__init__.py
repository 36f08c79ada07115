"""VeloANN on PyTorch and CUDA: the SSD-resident graph index served by
hand-written Hopper kernels.

Subpackages:
  core     — index build, buffer pool, coroutine engine, simulator and the
             distance plane (``core.distance.TorchEngine``)
  velo     — the HBM record-cache slot state (``velo.device_cache``)
  kernels  — the ``binary_ip`` and ``int4_dist`` kernels: CUDA C++ sources
             under ``csrc/``, each with its plain PyTorch version
  convert  — carries an index image built elsewhere into this package's
             dataclasses

Entry points run on the CUDA card unless the caller asks for the CPU
(``core.distance.set_default_device("cpu")`` or a ``device=`` argument).
This package imports ``torch`` and ``numpy`` only.
"""
