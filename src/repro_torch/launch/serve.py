"""Serving CLI: the end-to-end VeloANN driver (the paper is a serving system).

Builds the compressed index over a synthetic corpus, then pushes a batched
query stream through the asynchronous engine and reports the paper's
metrics (QPS / latency / recall / IO / hit rate).  The distance plane is the
torch engine on ``--device``: the CUDA card by default, which must be there;
``--device cpu`` runs the kernels' plain PyTorch versions.

  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --d 128 --queries 500
  PYTHONPATH=src python -m repro_torch.launch.serve --n 2000 --d 32 --queries 50 --device cpu

``main(argv)`` returns ``baselines.evaluate``'s dict.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import baselines, dataset, vamana
from repro_torch.core.quant import RabitQuantizer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--system", default="velo",
                    choices=["velo", "diskann", "starling", "pipeann", "inmemory"])
    ap.add_argument("--buffer-ratio", type=float, default=0.2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--L", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help='torch engine device: "cuda", "cuda:N" or "cpu" '
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    t0 = time.time()
    print(f"[serve] generating corpus n={args.n} d={args.d} ...", flush=True)
    ds = dataset.make_dataset(n=args.n, d=args.d, n_queries=args.queries,
                              k=10, seed=args.seed)
    print(f"[serve] building Vamana graph ... ({time.time()-t0:.1f}s)", flush=True)
    graph = vamana.build_vamana(ds.base, R=32, L=64, seed=args.seed)
    qb = RabitQuantizer(args.d, seed=args.seed).fit_encode(ds.base)
    print(f"[serve] index built ({time.time()-t0:.1f}s); running {args.system} ...",
          flush=True)

    cfg = baselines.SystemConfig(
        buffer_ratio=args.buffer_ratio, batch_size=args.batch,
        n_workers=args.workers, device=args.device,
        params=baselines.SearchParams(L=args.L, W=4),
    )
    system = baselines.build_system(args.system, ds.base, graph, qb, cfg)
    out = baselines.evaluate(system, ds)
    print(f"[serve] system={out['system']} recall@10={out['recall@k']:.3f} "
          f"QPS={out['qps']:.0f} mean_lat={out['mean_latency_ms']:.2f}ms "
          f"p99={out['p99_latency_ms']:.2f}ms io/q={out['ios_per_query']:.1f} "
          f"hit={out['hit_rate']:.2f}")
    print(f"[serve] disk={out['disk_bytes']/1e6:.1f}MB "
          f"memory={out['memory_bytes']/1e6:.1f}MB "
          f"(origin {ds.base.nbytes/1e6:.1f}MB)")
    return out


if __name__ == "__main__":
    main()
