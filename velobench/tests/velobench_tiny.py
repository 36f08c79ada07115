"""Small sizes of the two cells for the CPU tests: the same drivers, the
same reference and the same limits as the chip runs, fewer rows."""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from velobench import harness, registry  # noqa: E402

ENGINE, SCAN = "sift1m-velo.zipf", "veloann-scan.b4096"
SEED = 2**31 + 12345  # beyond 32 signed bits, as the driver's seeds may be


def cell(name: str) -> tuple[dict, dict]:
    c = registry.cell(name)
    cfg = registry.config(c["config"])
    if name == ENGINE:
        cfg.update(n=600, d=32)
        c["traffic"].update(pool=120, min_warmup_calls=2, max_warmup_calls=2)
    else:
        cfg.update(n=5000, d=32, chunk=1024)
        c["traffic"].update(pool=300, batch=64, sample=60)
    return c, cfg


def run(name: str, cache_dir, *, control: bool = False, seed: int = SEED,
        seconds: float = 0.5, device: str = "cpu", trace: bool = False):
    c, cfg = cell(name)
    return harness.run_cell(name, seed, seconds, trace, device, time.perf_counter(), cell=c,
                            cfg=cfg, control=control, cache_dir=cache_dir,
                            log=lambda msg: None)
