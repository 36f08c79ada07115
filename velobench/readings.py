#!/usr/bin/env python3
"""The readings that the limits of a cell's compared numbers are set from.

    python3 velobench/readings.py --workload <cell> --seeds 11,12,13 --seconds 30

For each seed, in one process: a run of the cell as ``run.py`` makes it,
then the same window's answers judged twice, the port's (the lower
readings) and the control's (the reference in the precision below the one
the configuration states, put in the port's place: the upper readings).
One JSON line a seed on standard output.  Needs the card, like ``run.py``.
"""

import time

import argparse
import json
import sys
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from velobench import harness

    if not torch.cuda.is_available():
        print("velobench: readings need the CUDA card", file=sys.stderr)
        return 2
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        try:
            r, _ = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", t0,
                                    control=True)
            metrics = {k: v["value"] for k, v in r["metrics"].items()}
            line = dict(seed=seed, correct=r["correct"], numbers=r["numbers"],
                        control=r["control"], metrics=metrics,
                        attempted=r["attempted"], failed=r["failed"],
                        memory_peak_bytes=r["device"]["memory_peak_bytes"])
        except Exception:  # one seed's failure is a reading too; the others go on
            line = dict(seed=seed, error=traceback.format_exc()[-2000:])
            rc = 1
        print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
