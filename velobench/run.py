#!/usr/bin/env python3
"""The benchmark of the port: one run of one cell on the card.

    python3 velobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress on standard error, then each compared number beside its
limit as the last lines there, and the result as one JSON object on the
last line of standard output.  Exits non-zero, with no result, when the
card or the cards the cell asks for are missing, when the port is not in
the checkout, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from velobench import harness, registry

    cell = registry.cell(args.workload)
    need = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"velobench: {args.workload} needs {need} CUDA card(s), this host has {have}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"velobench: JAX or the JAX package was loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
