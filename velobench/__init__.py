"""velobench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell::

    python3 velobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the harness runs is found by name, one file each:

  workloads/<cell>.json     a cell: its configuration, driver, traffic and limits
  configs/<config>.json     a deployment: sizes, source, cuts, guarantees
  drivers/<driver>.py       a serving path of the port, driven call by call
  metrics/<metric>.py       one metric's reader
  reference/                the plain NumPy / PyTorch reference (no import of
                            the port, of ``repro`` or of JAX)

Adding a configuration, a traffic mix or a metric is adding files and
``BENCHMARK.json`` entries.
"""
