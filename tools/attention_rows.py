#!/usr/bin/env python3
"""chip_smoke.py's phase 3 rows for one checkout, as JSON.

    python3 tools/attention_rows.py CHECKOUT OUT.json

Builds CHECKOUT's kernels, runs its ``chip_smoke.phase_kernels`` (the
distance rows: binary_ip's sign product, and from the fused-estimate
redesign on its estimate rows and sweeps; int4_dist) and
``chip_smoke.phase_attention`` on the CUDA card and writes the rows, the
card line and the build seconds to OUT.json.  A row names its kernel, entry
(where it has one), shape and dtype, so that the rows of two checkouts pair
up by those fields; rows only one checkout has stand alone.  To compare two commits on one card, unpack the other commit into
an ignored directory (``git archive``) and run both in one call, in turns:
parent, change, change, parent.
"""

import json
import os
import sys
import time

checkout, out_path = os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2])
os.chdir(checkout)
sys.path[:0] = [checkout, os.path.join(checkout, "src")]

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

t0 = time.perf_counter()
_build.build()
_build.load()
build_s = time.perf_counter() - t0

import chip_smoke  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
card = chip_smoke.card_line()
distance = chip_smoke.phase_kernels(torch.device("cuda"))
rows, _ = chip_smoke.phase_attention(torch.device("cuda"), card)
with open(out_path, "w") as f:
    json.dump(dict(checkout=checkout, card=card, build_s=build_s, rows=rows, distance=distance),
              f, indent=1)
