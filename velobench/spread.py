#!/usr/bin/env python3
"""The spreads that a cell's bounds are set from.

    python3 velobench/spread.py --workload <cell> --seeds 11,12,13,14,15,16 \
        --sets 2 --seconds 51 --out runs.jsonl

Runs ``run.py`` once a seed, each run its own process, in ``--sets`` sets
of the same seeds (set after set), and appends each run's result line to
``--out``.  Then prints, for each metric, each set's median and spread
(the distance between the first and third quartiles, as
``statistics.quantiles(values, n=4)`` gives them, over the median), the
same with each set's run farthest from its median left out, and five times
the widest spread (never under 1 %), the bound the benchmark's rules
suggest.  Needs the card the cell asks for, like ``run.py``.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list[float]) -> float:
    """(third quartile - first quartile) / median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else float("inf")


def spread_trimmed(values: list[float]) -> float:
    """``spread`` with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def summary(sets: list[list[dict]]) -> dict:
    """{metric: {"medians", "spreads", "trimmed", "bound"}} over the result
    lines of each set."""
    out = {}
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    for name in names:
        vals = [[r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
                for runs in sets]
        if any(len(v) < 3 for v in vals):
            continue
        spreads = [spread(v) for v in vals]
        out[name] = dict(medians=[statistics.median(v) for v in vals], spreads=spreads,
                         trimmed=[spread_trimmed(v) for v in vals],
                         bound=max(0.01, 5 * max(spreads)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated, one run a seed a set")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True, help="JSON lines, one a run, appended")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",")]
    sets, rc = [], 0
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            cmd = [sys.executable, str(HERE / "run.py"), "--workload", args.workload,
                   "--seed", str(seed), "--seconds", str(args.seconds),
                   "--trace", str(args.trace)]
            p = subprocess.run(cmd, capture_output=True, text=True)
            line = dict(set=k, seed=seed, rc=p.returncode, stderr_tail=p.stderr[-1500:])
            lines = p.stdout.strip().splitlines()
            if p.returncode == 0 and lines:
                line["result"] = json.loads(lines[-1])
                runs.append(line["result"])
            else:
                rc = 1
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
            got = line.get("result", {})
            print(f"set {k} seed {seed}: rc {p.returncode} correct {got.get('correct')} "
                  + " ".join(f"{m} {v['value']!r}" for m, v in got.get("metrics", {}).items()),
                  flush=True)
        sets.append(runs)
    for name, s in summary(sets).items():
        print(f"{name}: medians {s['medians']}, spreads {s['spreads']}, "
              f"trimmed {s['trimmed']}, 5x widest {s['bound']:.4f}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
