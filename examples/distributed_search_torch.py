"""Distributed vector search over a process group on the PyTorch port (the
steps of examples/distributed_search.py).

Shards a corpus over the ranks of a process group, one shard and its own
local graph a rank, runs the two-stage compressed scan per shard
(``velo.dist_search``, scan mode: binary_ip's stage 1 and the int4
rerank, on the card the hand-written kernels) and merges the shards' top-k
with an all-gather.  On the CPU, 8 gloo ranks hold the reference's 8
shards; on the card, one NCCL rank holds the corpus as one shard (NCCL
refuses two ranks on one card).

  PYTHONPATH=src python examples/distributed_search_torch.py                # the card
  PYTHONPATH=src python examples/distributed_search_torch.py --device cpu
"""

import argparse
import dataclasses
import socket
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.core import dataset, vamana  # noqa: E402
from repro_torch.core.dataset import recall_at_k  # noqa: E402
from repro_torch.core.quant import RabitQuantizer  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.velo import dist_search  # noqa: E402
from repro_torch.velo.index import from_host  # noqa: E402

CPU_RANKS = 8
JOIN_S = 600


def shard_index(ds, qb, rank: int, world: int, device):
    """Rank ``rank``'s shard of the corpus with its local graph (standard
    sharded-ANN construction), and the shard's first global id."""
    per = ds.n // world
    lo, hi = rank * per, (rank + 1) * per
    g = vamana.build_vamana(ds.base[lo:hi], R=12, L=24, seed=rank, two_pass=False)
    sub = dataclasses.replace(
        qb,
        binary_codes=qb.binary_codes[lo:hi], norms=qb.norms[lo:hi],
        ip_bar=qb.ip_bar[lo:hi], ext_codes=qb.ext_codes[lo:hi],
        ext_lo=qb.ext_lo[lo:hi], ext_step=qb.ext_step[lo:hi],
    )
    return from_host(sub, g, device=device), lo


def rank_main(rank: int, world: int, port: int, device_type: str, results) -> None:
    """One rank: its shard, the distributed search; rank 0 sends the merged
    ids, their recall@10 and the corpus size through ``results``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dev = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        ds = dataset.make_dataset(n=4096, d=64, n_queries=64, k=10, seed=3)
        qb = RabitQuantizer(64, seed=0).fit_encode(ds.base)
        index, offset = shard_index(ds, qb, rank, world, dev)
        search = dist_search.make_distributed_search(mode="scan", L=64, k=10)
        ids, _ = search(index, offset, torch.from_numpy(ds.queries).to(dev))
        if rank == 0:
            ids = ids.cpu().numpy()
            results.send((ids, recall_at_k(ids, ds.groundtruth, 10), ds.n))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    world = CPU_RANKS if dev.type == "cpu" else 1

    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, dev.type, send))
             for r in range(world)]
    for p in procs:
        p.start()
    # read rank 0's result before joining (a full pipe would block its exit)
    deadline = time.monotonic() + JOIN_S
    while procs[0].is_alive() and not recv.poll(1.0) and time.monotonic() < deadline:
        pass
    got = recv.recv() if recv.poll() else None
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed or got is None:
        raise RuntimeError(f"ranks {failed} of {world} failed")
    ids, rec, n = got
    print(f"devices={world} corpus={n} sharded search recall@10={rec:.3f}")
    assert rec > 0.8
    print("OK")
    return ids, rec


if __name__ == "__main__":
    main()
