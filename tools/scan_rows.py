#!/usr/bin/env python3
"""scan_search over a 1M x 128 table on the card, timed, for one checkout.

    python3 tools/scan_rows.py CHECKOUT OUT.json [--batches 8,64,4096]

Builds CHECKOUT's kernels, encodes 2^20 seeded Gaussian rows with its
``RabitQuantizer`` (seed 0: every checkout scans the same index), and times
``velo.scan_search.scan_search`` (k 10, rerank 64, the default chunk: 32
chunks) at each batch of seeded queries: the wall time of a call that ends
in a synchronise (what the benchmark's scan cell measures) and the CUDA-event
time between the call's first and last launch, medians of 10 calls after 2
warm-up calls; where the checkout has the ``scan_select`` kernel, also the
(row, chunk) pairs of one call that took its full select.  Writes the
rows, the ids of each batch's answer (so that two checkouts' answers can be
held equal), the card line and the build seconds to OUT.json.  To compare two commits on one card, unpack the other commit
into an ignored directory (``git archive``) and run both in one call, in
turns: parent, change, change, parent.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import types

ap = argparse.ArgumentParser()
ap.add_argument("checkout")
ap.add_argument("out")
ap.add_argument("--batches", default="8,64,4096")
args = ap.parse_args()
checkout, out_path = os.path.abspath(args.checkout), os.path.abspath(args.out)
os.chdir(checkout)
sys.path[:0] = [checkout, os.path.join(checkout, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.quant import RabitQuantizer  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.velo import index as velo_index  # noqa: E402
from repro_torch.velo import scan_search as ss  # noqa: E402

try:
    from repro_torch.kernels.scan_select import kernel as select
except ImportError:  # a checkout from before the kernel
    select = None

t0 = time.perf_counter()
_build.build()
_build.load()
build_s = time.perf_counter() - t0
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip().splitlines()[0]
n, d = 1 << 20, 128
rng = np.random.default_rng(0)
qb = RabitQuantizer(d, seed=0).fit_encode(rng.standard_normal((n, d), dtype=np.float32))
empty = types.SimpleNamespace(adjacency=np.full((n, 1), -1, np.int32), medoid=0)
idx = velo_index.from_host(qb, empty, device="cuda")
pool = rng.standard_normal((4096, d), dtype=np.float32)

rows = []
for B in (int(b) for b in args.batches.split(",")):
    q = torch.from_numpy(pool[:B])
    for _ in range(2):
        ids, _ = ss.scan_search(idx, q, k=10, rerank=64)
    torch.cuda.synchronize()
    wall, dev = [], []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        ids, _ = ss.scan_search(idx, q, k=10, rerank=64)
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        dev.append(start.elapsed_time(end))
    full = None
    if select is not None:
        select.reset_full_select_rows()
        ss.scan_search(idx, q, k=10, rerank=64)
        full = select.full_select_rows()
    rows.append(dict(name="scan_search 1M", B=B, call_ms=float(np.median(wall)),
                     event_ms=float(np.median(dev)), call_ms_all=wall, full_select_rows=full,
                     ids=ids.cpu().numpy().tolist()))
    print(f"scan_search 1M B={B}: call {rows[-1]['call_ms']:.3f} ms, "
          f"events {rows[-1]['event_ms']:.3f} ms, full selects {full}", flush=True)
with open(out_path, "w") as f:
    json.dump(dict(checkout=checkout, card=card, build_s=build_s, rows=rows), f)
