"""The on-card scan by inner product: ``velo.scan_search.scan_search`` on a
``velo.index.DeviceIndex`` encoded with ``RabitQuantizer(d, metric="ip")``.

As ``drivers/scan.py``, with the inner-product deployment's pieces: set-up
generates the rows and the out-of-distribution query pool with
``data_ip.py`` (from the configuration's ``data_seed``, the pool in an order
drawn from the run's seed), encodes them with the port's inner-product
quantizer (the codes padded from d to D, a per-row ``cr``) and moves the
index to the card with ``from_host``, with an empty graph of the published
degree that scan mode never reads.  A call is one ``scan_search`` of the
next ``batch`` queries of the pool, cycling through it, handed over from the
host; the call ends with a synchronise, and its time is the latency of each
of its queries.  An answer is (ids, negated inner products), best first.

The quantizer is asked for inner product before anything is generated, so
that a port without it fails at once.

After the window the reference (``reference/rabitq_ip.py``,
``reference/scan_ip.py``, ``reference/exact_ip.py``) judges every answer:
``bad_answers`` (``judge.bad``), ``score_gap`` (the widest gap between a
returned score and the reference's float64 score of that row for that
query, over ``|<q, c>| + |q - c| |o - c| + |cr|``, the size of the terms it
sums, so that a score near 0 is judged by its terms) and ``id_mismatch``
(against the reference's own scan of a sample of the queries).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from repro_torch.core.quant import RabitQuantizer
from repro_torch.kernels.binary_ip import kernel as bip_kernel
from repro_torch.kernels.scan_select import kernel as sel_kernel
from repro_torch.velo import index as velo_index
from repro_torch.velo import scan_search as scan_mod

from velobench import data_ip, judge
from velobench.reference import exact_ip, rabitq_ip, scan_ip


def score_gap(t: rabitq_ip.Tables, enc: rabitq_ip.Encoding, queries: np.ndarray,
              inv: np.ndarray, ids: np.ndarray, scores: np.ndarray, device,
              block: int = 8192) -> np.ndarray:
    """(m,) the widest |returned - reference| / size over each answer's rows:
    answer j is of query ``queries[inv[j]]``; rows outside the table (bad
    answers) and non-finite scores read as 0 here (``bad`` counts them)."""
    n = t.codes.shape[0]
    qr64, qc64 = rabitq_ip.prepare(enc, queries)
    qr = torch.from_numpy(qr64).to(device)
    qc = torch.from_numpy(qc64).to(device)
    qrn = torch.linalg.vector_norm(qr, dim=1)
    out = np.zeros(len(ids))
    for s in range(0, len(ids), block):
        i = torch.from_numpy(np.clip(ids[s:s + block], 0, n - 1)).to(device)
        o = torch.from_numpy(inv[s:s + block]).to(device)
        ref = rabitq_ip.score(t, qr[o], qc[o], i)
        size = (qc[o].abs()[:, None] + qrn[o][:, None] * t.norms[i].to(torch.float64)
                + t.cr[i].to(torch.float64).abs())
        got = torch.from_numpy(scores[s:s + block]).to(device)
        gap = ((got - ref).abs() / torch.clamp_min(size, 1e-12)).cpu().numpy()
        gap[(ids[s:s + block] < 0) | (ids[s:s + block] >= n)] = 0.0
        gap = np.where(np.isfinite(gap), gap, 0.0)
        out[s:s + block] = gap.max(axis=1) if gap.shape[1] else 0.0
    return out


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans, log=print,
                 cache_dir=None):
        self.cfg, self.traffic, self.seed, self.spans = cfg, traffic, seed, spans
        self.k, self.B = cfg["k"], traffic["batch"]
        self.device = torch.device(device)
        self.index_seed = int(cfg["data_seed"])
        quant = RabitQuantizer(cfg["d"], seed=self.index_seed, metric=cfg["metric"])
        self.base, self.pool = data_ip.inputs(cfg, traffic, seed)
        if self.B > len(self.pool):
            raise ValueError(f"batch {self.B} exceeds the pool of {len(self.pool)} queries")
        qb = quant.fit_encode(self.base)
        if qb.dim != cfg["D"]:
            raise ValueError(f"the quantizer pads d {cfg['d']} to {qb.dim}, not D {cfg['D']}")
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
            ids, score = scan_mod.scan_search(self.index, q, k=self.k, rerank=c["rerank"],
                                              chunk=c["chunk"])
            self._sync()
            t1 = time.perf_counter()
        self.window.append((s, ids, score))
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
        """The kernels' launch counters, and ``scan_select``'s device count of
        full selects (a synchronisation: read at each end of the window)."""
        return {"binary_ip.launches": bip_kernel.launches,
                "binary_ip.tensor_core_launches": bip_kernel.tensor_core_launches,
                "scan_select.launches": sel_kernel.launches,
                "scan_select.ip_launches": sel_kernel.ip_launches,
                "scan_select.full_select_rows": sel_kernel.full_select_rows()}

    def launch_shapes(self) -> dict:
        """One call's launches: ``binary_ip``'s (B, N, D) and ``scan_select``'s
        (B, L, C, carried), one each a chunk of ``chunk`` rows and one each
        for the tail (one in all, with no carry, when the table is a single
        chunk)."""
        n, D, chunk = self.cfg["n"], self.cfg["D"], self.cfg["chunk"]
        C = min(self.cfg["rerank"], n)
        if n <= chunk:
            return {"binary_ip": [(self.B, n, D)], "scan_select": [(self.B, n, C, False)]}
        rows = [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])
        return {"binary_ip": [(self.B, L, D) for L in rows],
                "scan_select": [(self.B, L, C, True) for L in rows]}

    def answers(self) -> dict:
        qidx, res = [], []
        for s, ids, score in self.window:
            qidx.append(self.stream[s:s + self.B])
            ids, score = ids.cpu().numpy(), score.cpu().numpy()
            res += [(ids[i], score[i]) if i < len(ids) else None for i in range(self.B)]
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
        enc = rabitq_ip.encode(self.base, self.index_seed)
        t = scan_ip.ScanTables(enc, device)
        uniq, first, inv = np.unique(ans["qidx"], return_index=True, return_inverse=True)
        ids, dists = ans["ids"], ans["dists"]
        if control:
            c_ids, c_s = scan_ip.scan(t, enc, self.pool[uniq], self.k, c["rerank"], control=True)
            ids, dists = c_ids[inv], c_s[inv]
        bad = judge.bad(ids, dists, c["n"])
        gap = score_gap(t, enc, self.pool[uniq], inv, ids, dists, device)
        rng = np.random.default_rng(self.seed)
        pick = np.sort(rng.choice(len(uniq), size=min(self.traffic["sample"], len(uniq)),
                                  replace=False))
        want, _ = scan_ip.scan(t, enc, self.pool[uniq[pick]], self.k, c["rerank"])
        mismatch = judge.id_mismatch(ids[first[pick]], want)
        del t
        gt = exact_ip.topk(self.base, self.pool[uniq], self.k, device)[inv]
        return dict(numbers=dict(bad_answers=int(bad.sum()),
                                 score_gap=float(gap.max(initial=0.0)), id_mismatch=mismatch),
                    per_answer=dict(bad=bad, score_gap=gap), recall=judge.recall(ids, gt))
