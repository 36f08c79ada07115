"""The on-card scan: ``velo.scan_search.scan_search`` on a
``velo.index.DeviceIndex``.

Set-up generates the deployment's rows (``data.inputs``: from the
configuration's ``data_seed`` where it names one, with the pool in an order
drawn from the run's seed), encodes them with the port's
``RabitQuantizer.fit_encode`` (the same seed's rotation) and moves the index
to the card with ``from_host``.  Scan mode reads no adjacency, so the index
carries an empty graph of the published degree (every entry the padding id),
not a host build that would take hours at a million rows.  A call is one
``scan_search`` of the next ``batch`` queries of the pool, cycling
through it, handed over from the host; the call ends with a synchronise, and
its time is the latency of each of its queries.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from repro_torch.core.quant import RabitQuantizer
from repro_torch.kernels.binary_ip import kernel as bip_kernel
from repro_torch.kernels.int4_dist import kernel as i4_kernel
from repro_torch.velo import index as velo_index
from repro_torch.velo import scan_search as scan_mod

from velobench import data, judge
from velobench.reference import exact, rabitq
from velobench.reference import scan as scan_ref


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans, log=print,
                 cache_dir=None):
        self.cfg, self.traffic, self.seed, self.spans = cfg, traffic, seed, spans
        self.k, self.B = cfg["k"], traffic["batch"]
        self.device = torch.device(device)
        self.base, self.pool = data.inputs(cfg, traffic, seed)
        if self.B > len(self.pool):
            raise ValueError(f"batch {self.B} exceeds the pool of {len(self.pool)} queries")
        self.index_seed = data.index_seed(cfg, seed)
        qb = RabitQuantizer(cfg["d"], seed=self.index_seed).fit_encode(self.base)
        empty = types.SimpleNamespace(
            adjacency=np.full((cfg["n"], cfg["R"]), -1, dtype=np.int32), medoid=0)
        self.index = velo_index.from_host(qb, empty, device=self.device)
        del qb, empty
        self.stream = np.concatenate([np.arange(len(self.pool))] * 2)
        self.pool2 = self.pool[self.stream]
        self.pos = 0
        self.window: list[tuple[int, torch.Tensor, torch.Tensor]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the timed path ---------------------------------------------------

    def call(self) -> list[float]:
        s = self.pos % len(self.pool)
        self.pos += self.B
        q = torch.from_numpy(self.pool2[s:s + self.B])
        c = self.cfg
        with self.spans.span("scan.call"):
            t0 = time.perf_counter()
            ids, d2 = scan_mod.scan_search(self.index, q, k=self.k, rerank=c["rerank"],
                                           chunk=c["chunk"])
            self._sync()
            t1 = time.perf_counter()
        self.window.append((s, ids, d2))
        return [t1 - t0] * self.B

    def warmup(self) -> int:
        """Two calls: every shape of the window (one batch size, the chunks
        and the tail) runs in the first."""
        for _ in range(2):
            self.call()
        return 2

    def begin_window(self) -> None:
        self.window.clear()

    def counters(self) -> dict:
        return {"binary_ip.launches": bip_kernel.launches,
                "binary_ip.tensor_core_launches": bip_kernel.tensor_core_launches,
                "int4_dist.launches": i4_kernel.launches}

    def launch_shapes(self) -> dict:
        """The (B, N, d) of each ``binary_ip`` launch of one call: one per
        chunk of ``chunk`` rows and one for the tail (one in all when the
        table is a single chunk)."""
        n, d, chunk = self.cfg["n"], self.cfg["d"], self.cfg["chunk"]
        if n <= chunk:
            return {"binary_ip": [(self.B, n, d)]}
        shapes = [(self.B, chunk, d)] * (n // chunk)
        if n % chunk:
            shapes.append((self.B, n % chunk, d))
        return {"binary_ip": shapes}

    def answers(self) -> dict:
        qidx, res = [], []
        for s, ids, d2 in self.window:
            qidx.append(self.stream[s:s + self.B])
            ids, d2 = ids.cpu().numpy(), d2.cpu().numpy()
            res += [(ids[i], d2[i]) if i < len(ids) else None for i in range(self.B)]
        ids, dists = judge.stack(res, self.k)
        return dict(qidx=np.concatenate(qidx) if qidx else np.zeros(0, int), ids=ids, dists=dists)

    def release(self) -> None:
        self.index = None
        self.window.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- after the window: the reference ----------------------------------

    def judge(self, ans: dict, device, control: bool = False) -> dict:
        c = self.cfg
        enc = rabitq.encode(self.base, self.index_seed)
        t = scan_ref.ScanTables(enc, device)
        uniq, first, inv = np.unique(ans["qidx"], return_index=True, return_inverse=True)
        ids, dists = ans["ids"], ans["dists"]
        if control:
            c_ids, c_d = scan_ref.scan(t, self.pool[uniq], self.k, c["rerank"], control=True)
            ids, dists = c_ids[inv], c_d[inv]
        qr = torch.from_numpy(rabitq.rotate(enc, self.pool[uniq])).to(device)
        bad = judge.bad(ids, dists, c["n"])
        gap = judge.dist_gap(t, qr[torch.from_numpy(inv).to(device)], ids, dists)
        rng = np.random.default_rng(self.seed)
        pick = np.sort(rng.choice(len(uniq), size=min(self.traffic["sample"], len(uniq)),
                                  replace=False))
        want, _ = scan_ref.scan(t, self.pool[uniq[pick]], self.k, c["rerank"])
        mismatch = judge.id_mismatch(ids[first[pick]], want)
        del t
        gt = exact.topk(self.base, self.pool[uniq], self.k, device)[inv]
        return dict(numbers=dict(bad_answers=int(bad.sum()), dist_gap=float(gap.max(initial=0.0)),
                                 id_mismatch=mismatch),
                    per_answer=dict(bad=bad, dist_gap=gap), recall=judge.recall(ids, gt))
