"""The plain reference of the benchmark's two deployments.

NumPy and plain PyTorch only: nothing here imports ``repro_torch``,
``repro`` or JAX, and nothing takes a table the port made.  From the
generated base vectors and the seed it works out again the RaBitQ tables
(``rabitq``), the exact top-k (``exact``) and the on-card scan's answers
(``scan``); the harness hands it the port's answers only to judge them.
"""
