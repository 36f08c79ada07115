#!/usr/bin/env python3
"""The per-row ``cr = <c, o - c>`` of text2image-scan.b4096 at the cell's own
size, on the card.

    python3 tools/scan_ip_cr.py --seed 4100000011 --seconds 10 [--out FILE.jsonl]

Two runs of the cell in one process, each as ``velobench/run.py`` makes it:

1. the port, traced: the compared numbers beside their limits and the
   cell's per-layer metrics, with the squared-L2 scan cells' generic readers
   ``scan.launches_per_call`` and ``scan.sort_share`` read too (BENCHMARK.json
   does not list the cell under them); and the sizes of the estimator's
   terms: the centroid's norm, |cr| over the rows (median, 99th percentile,
   max), |o - c| over the rows and |q - c| and |<q, c>| over the query pool
   (medians), and one bf16 ulp at the median |q - c| |o - c|, the size of
   the term that stage 1 adds cr to;
2. the planted fault "cr dropped" (the index's cr set to 0 before the
   window, as ``velobench/tests/test_velobench_text2image.py`` plants it at a
   tiny size): the compared numbers, the verdict, ``qps`` and recall.

One JSON line a run, on standard output and in ``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.velo import index as velo_index  # noqa: E402
from velobench import harness, registry  # noqa: E402

CELL = "text2image-scan.b4096"
GENERIC = ("scan.launches_per_call", "scan.sort_share")


def _spread(x: np.ndarray) -> dict:
    x = np.abs(np.asarray(x, dtype=np.float64))
    return dict(median=float(np.median(x)), p99=float(np.quantile(x, 0.99)), max=float(x.max()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_ip_cr: needs the CUDA card", file=sys.stderr)
        return 2

    state = dict(drop=False, centroid=None)
    sizes: dict = {}
    # the cell's driver module, loaded once and handed to the harness (the
    # registry loads a fresh copy by file at every call)
    drv_name = registry.cell(CELL)["driver"]
    drv_mod, driver = registry.driver(drv_name), registry.driver
    drv_cls = drv_mod.Driver
    from_host, judge, metrics_for = velo_index.from_host, drv_cls.judge, registry.metrics_for

    def hooked_from_host(qb, graph, device=None):
        index = from_host(qb, graph, device)
        if state["drop"]:
            index.cr[:-1] = 0.0
        else:
            state["centroid"] = qb.centroid[:qb.in_dim].astype(np.float64)
            sizes.update(centroid_norm=float(np.linalg.norm(state["centroid"])),
                         cr_abs=_spread(qb.cr), resid_norm_median=float(np.median(qb.norms)))
        return index

    def hooked_judge(self, ans, device, control=False):
        if not state["drop"] and not control:
            c = state["centroid"]
            pool = self.pool.astype(np.float64)
            qr = float(np.median(np.linalg.norm(pool - c, axis=1)))
            term = qr * sizes["resid_norm_median"]
            sizes.update(query_resid_norm_median=qr,
                         query_centroid_ip_abs_median=float(np.median(np.abs(pool @ c))),
                         middle_term_median=term,
                         bf16_ulp_at_middle_term=2.0 ** (math.floor(math.log2(term)) - 7))
        return judge(self, ans, device, control)

    def hooked_metrics_for(bench, cell_name, trace):
        out = metrics_for(bench, cell_name, trace)
        if trace:
            out = out + [m for m in bench["per_layer"] if m["name"] in GENERIC and m not in out]
        return out

    velo_index.from_host = hooked_from_host
    drv_cls.judge = hooked_judge
    registry.metrics_for = hooked_metrics_for
    registry.driver = lambda name, here=None: drv_mod if name == drv_name else driver(name, here)
    lines = []
    t0 = T_START
    for name, drop, trace in (("port", False, True), ("cr dropped", True, False)):
        state["drop"] = drop
        result, _ = harness.run_cell(CELL, args.seed, args.seconds, trace, "cuda", t0)
        line = dict(run=name, seed=args.seed, correct=result["correct"],
                    checks=result["checks"], metrics={k: v["value"]
                                                      for k, v in result["metrics"].items()})
        if not drop:
            line["sizes"] = dict(sizes)
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
