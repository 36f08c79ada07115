"""End-to-end serving driver on the PyTorch port (the steps of
examples/serve_batch.py):

  * builds the compressed index over a 10k corpus,
  * replays a batched query stream through the coroutine engine under three
    configurations (sync DiskANN-style baseline, async VeloANN, in-memory),
    every distance on the port's ``torch`` engine (on the card: the
    hand-written binary_ip and int4_dist kernels),
  * prints the throughput/latency/recall comparison — the local version of
    the paper's Fig. 1.

  PYTHONPATH=src python examples/serve_batch_torch.py                # the card
  PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

from repro_torch.core import baselines, dataset, vamana  # noqa: E402
from repro_torch.core.quant import RabitQuantizer  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.time()
    ds = dataset.make_dataset(n=10000, d=64, n_queries=400, k=10, seed=1)
    graph = vamana.build_vamana(ds.base, R=24, L=48, seed=1)
    qb = RabitQuantizer(ds.dim, seed=1).fit_encode(ds.base)
    print(f"index built in {time.time()-t0:.1f}s "
          f"(n={ds.n}, affinity sets={len(graph.affinity)})")

    rows = []
    for name, batch, workers in (
        ("diskann", 1, 4),      # synchronous baseline
        ("pipeann", 1, 4),      # pipelined best-first
        ("velo", 8, 4),         # coroutine-async VeloANN
        ("inmemory", 8, 4),     # the upper bound
    ):
        cfg = baselines.SystemConfig(
            buffer_ratio=0.2, batch_size=batch, n_workers=workers, device=str(dev),
            params=baselines.SearchParams(L=48, W=4),
        )
        system = baselines.build_system(name, ds.base, graph, qb, cfg)
        out = baselines.evaluate(system, ds)
        rows.append((name, out))
        print(f"{name:10s} recall={out['recall@k']:.3f} "
              f"QPS={out['qps']:8.0f} lat={out['mean_latency_ms']:6.2f}ms "
              f"io/q={out['ios_per_query']:5.1f} hit={out['hit_rate']:.2f}")

    by = dict(rows)
    speedup = by["velo"]["qps"] / by["diskann"]["qps"]
    frac = by["velo"]["qps"] / by["inmemory"]["qps"]
    print(f"\nvelo vs diskann: {speedup:.1f}x QPS "
          f"(paper: up to 5.8x); velo vs in-memory: {frac:.2f}x "
          f"(paper: up to 0.92x at 50% buffer)")
    assert speedup > 2.0
    print("OK")


if __name__ == "__main__":
    main()
