"""Quickstart on the PyTorch port: build a VeloANN index, search it, check
recall (the steps of examples/quickstart.py).

Every distance runs on the port's ``torch`` engine: on the card its
level-1 estimates and level-2 refines are the hand-written binary_ip and
int4_dist kernels.

  PYTHONPATH=src python examples/quickstart_torch.py                # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
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
    # 1. a synthetic 5k x 64d corpus with exact ground truth
    ds = dataset.make_dataset(n=5000, d=64, n_queries=200, k=10, seed=0)

    # 2. Vamana proximity graph with fused affinity coloring (paper Alg. 1)
    graph = vamana.build_vamana(ds.base, R=24, L=48, seed=0)
    print(f"graph built: {graph.n} vertices, mean degree "
          f"{graph.degrees.mean():.1f}, {len(graph.affinity)} affinity sets "
          f"({time.time()-t0:.1f}s)")

    # 3. two-level RaBitQ-style compression (1-bit resident + 4-bit on disk)
    qb = RabitQuantizer(ds.dim, seed=0).fit_encode(ds.base)

    # 4. the full VeloANN system: compressed slotted layout + record-level
    #    buffer pool + async coroutine engine + cache-aware beam search,
    #    its distances on the torch engine
    cfg = baselines.SystemConfig(
        buffer_ratio=0.2, batch_size=8, device=str(dev),
        params=baselines.SearchParams(L=48, W=4),
    )
    system = baselines.build_system("velo", ds.base, graph, qb, cfg)
    out = baselines.evaluate(system, ds)

    print(f"recall@10 = {out['recall@k']:.3f}")
    print(f"QPS       = {out['qps']:.0f} (simulated NVMe + 1 worker, B=8)")
    print(f"latency   = {out['mean_latency_ms']:.2f} ms mean, "
          f"{out['p99_latency_ms']:.2f} ms p99")
    print(f"I/O       = {out['ios_per_query']:.1f} page reads/query, "
          f"hit rate {out['hit_rate']:.2f}")
    print(f"disk      = {out['disk_bytes']/1e6:.2f} MB "
          f"(raw vectors: {ds.base.nbytes/1e6:.2f} MB)")
    assert out["recall@k"] > 0.6
    print("OK")


if __name__ == "__main__":
    main()
