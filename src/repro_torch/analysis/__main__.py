"""CLI for the protocol verifier.

Lint mode (default):      python -m repro_torch.analysis [paths]
Schedule-explore smoke:   python -m repro_torch.analysis --explore --seed 1 --schedules 5 [--device cpu]

Lint mode runs the static AST passes over the given files/directories and
prints one ``file:line: [rule] message`` line per finding (exit 1 when any
fire).  ``--explore`` runs every search algorithm over a small clustered
workload under N permuted schedules with the dynamic protocol checker armed
and verifies the results are bitwise schedule-invariant (exit 1 on any
mismatch or protocol violation); tie counts are printed so a vacuous pass —
schedules that never had a choice to permute — is visible.  The default
lint path is this package's own source tree; ``--explore`` runs the torch
engine on ``--device`` (default: the CUDA card, which must be there).
"""

from __future__ import annotations

import argparse
import os
import sys

# this package's source tree, wherever it is imported from
_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static lint + schedule-exploring protocol verifier",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: this "
                         "package's source tree)")
    ap.add_argument("--explore", action="store_true",
                    help="run the schedule-permutation smoke instead of lint")
    ap.add_argument("--schedules", type=int, default=5,
                    help="number of permuted schedules per algorithm")
    ap.add_argument("--seed", type=int, default=1,
                    help="first schedule seed (seeds run seed..seed+N-1)")
    ap.add_argument("--algorithms",
                    default="velo,diskann,starling,pipeann,inmemory",
                    help="comma-separated systems for --explore (velo runs "
                         "with the cache-aware pivot off — see explore.smoke)")
    ap.add_argument("--device", default="cuda",
                    help="torch engine device for --explore (\"cuda\", "
                         "\"cuda:N\" or \"cpu\"; default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.explore:
        from repro_torch.analysis.explore import smoke, smoke_sla

        algorithms = tuple(a for a in args.algorithms.split(",") if a)
        reports = smoke(algorithms=algorithms, n_schedules=args.schedules,
                        base_seed=args.seed, device=args.device)
        # The SLA scheduler leg: a pure-EDF serving plane under burst
        # arrivals, where equal deadlines create the slack ties to permute.
        reports.update(smoke_sla(n_schedules=args.schedules,
                                 base_seed=args.seed, device=args.device))
        failed = False
        for name, reps in reports.items():
            worker_ties = sum(r.ties["worker"] for r in reps)
            event_ties = sum(r.ties["event"] for r in reps)
            slack_ties = sum(r.ties.get("slack", 0) for r in reps)
            bad = [r for r in reps if not r.equal]
            verdict = "schedule-invariant" if not bad else "MISMATCH"
            print(f"{name}: {len(reps) - 1} schedule(s) explored, "
                  f"{worker_ties} worker tie(s), {event_ties} event tie(s), "
                  f"{slack_ties} slack tie(s) permuted -> {verdict}")
            for r in bad:
                failed = True
                print(f"  seed {r.seed}: {r.first_diff}")
        return 1 if failed else 0

    from repro_torch.analysis.lint import run_lint

    paths = args.paths or [_PACKAGE_DIR]
    findings = run_lint(paths)
    for f in findings:
        print(f.format())
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
