#!/usr/bin/env python3
"""Host time of the distance kernels' launch wrappers, per call, on the card.

    python3 tools/wrapper_host_us.py [OUT.json]

At the search path's flush shape (8 queries x 256 ids gathered from a 1M x
128 table) a call's device time is a few microseconds and its wrapper's host
time is most of what CUDA events around one call read.  This times, on the
host clock over 20 000 back-to-back calls (three repeats each), the public
wrappers ``int4_dist2``, ``binary_ip`` and ``estimate_dist2`` (the fused
RaBitQ estimate, which the search path calls) and the parts of a launch:
the ctypes call alone (the C entry and the kernel launch), ``torch.empty``
of the output, and the raw-stream lookup.  Prints one line per part and writes
the numbers, with the card line, to OUT.json when given.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.binary_ip import ops as bip_ops  # noqa: E402
from repro_torch.kernels.int4_dist import ops as i4_ops  # noqa: E402


def per_call_us(fn, n: int = 20_000, repeats: int = 3) -> list[float]:
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wrapper_host_us: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    lib = _build.load()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    T, d, B, N = 1_000_000, 128, 8, 256
    q = torch.randn(B, d, device=dev, generator=g)
    codes = torch.randint(0, 256, (T, d // 2), device=dev, dtype=torch.uint8, generator=g)
    signs = torch.randint(0, 256, (T, d // 8), device=dev, dtype=torch.uint8, generator=g)
    lo = torch.rand(T, device=dev, generator=g)
    step = torch.rand(T, device=dev, generator=g)
    norms = torch.rand(T, device=dev, generator=g) + 0.5
    ip_bar = torch.rand(T, device=dev, generator=g) * 0.3 + 0.6
    ids = torch.randint(0, T, (N,), device=dev, generator=g)
    out = torch.empty(B, N, device=dev)
    args = (q.data_ptr(), codes.data_ptr(), lo.data_ptr(), step.data_ptr(), ids.data_ptr(),
            out.data_ptr(), B, N, d, T, dev.index, _build.stream(dev))
    est_args = (q.data_ptr(), signs.data_ptr(), norms.data_ptr(), ip_bar.data_ptr(),
                ids.data_ptr(), out.data_ptr(), B, N, d, T, 0, dev.index, _build.stream(dev))
    parts = {
        "int4_dist2 (public wrapper)": lambda: i4_ops.int4_dist2(q, codes, lo, step, ids),
        "binary_ip (public wrapper)": lambda: bip_ops.binary_ip(q, signs, ids),
        "estimate_dist2 (public wrapper)":
            lambda: bip_ops.estimate_dist2(q, signs, norms, ip_bar, ids),
        "int4_dist_f32 ctypes call alone": lambda: lib.int4_dist_f32(*args),
        "binary_est_f32 ctypes call alone": lambda: lib.binary_est_f32(*est_args),
        "torch.empty of the output": lambda: torch.empty((B, N), dtype=torch.float32, device=dev),
        "_build.stream": lambda: _build.stream(dev),
    }
    res = {}
    print(f"host us per call, B={B} N={N} d={d} ids into {T} rows, on {card}:")
    for name, fn in parts.items():
        res[name] = per_call_us(fn)
        print(f"  {name:34s} " + " ".join(f"{x:7.2f}" for x in res[name]))
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(dict(card=card, us_per_call=res), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
