"""The disk-path engine: ``baselines.build_system("velo", ...)`` and
``System.run``, the paper's serving path.

Set-up generates the deployment's data (``data.inputs``: one index from
the configuration's ``data_seed``, its query pool in an order drawn from the
run's seed), opens (or builds) its Vamana graph, encodes the base with the
port's ``RabitQuantizer`` and builds the system with the distance plane on
the card, as ``launch/serve.py`` does, the build seeds being the data's.  A call
is one ``System.run`` over the next ``call_queries`` queries of the pool,
wrapping around it.  A query's latency runs from the start of its call to
the wall time at which its search coroutine returns: the harness wraps
``System.make_coroutine`` on the instance in a generator that passes every
op and every resumed value through (the engine drives the coroutine by
``send`` alone).  The wrapper also keeps each level-1 estimate the search
was resumed with, beside the ids it asked for, for the reference to judge.
Each public method of the distance plane (``system.ctx.dist``) is wrapped
in a span.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import baselines, vamana
from repro_torch.core.quant import RabitQuantizer
from repro_torch.core.search import SearchParams
from repro_torch.kernels.binary_ip import kernel as bip_kernel
from repro_torch.kernels.int4_dist import kernel as i4_kernel

from velobench import data, index_cache, judge
from velobench.reference import exact, rabitq

DIST_METHODS = (
    "estimate", "refine_ids", "refine", "refine_slots", "refine_slots_many", "refine_full",
    "estimate_many", "refine_ids_many", "refine_many", "refine_full_many",
    "beam_step", "beam_step_many", "beam_score_local", "beam_score_local_many",
    "beam_finalize",
)
RUN_COUNTERS = ("io_count", "cache_hits", "cache_misses", "coroutine_switches")
DIST_COUNTERS = ("level1_calls", "level1_rows", "level2_calls", "level2_rows")


def build_params(cfg: dict) -> dict:
    ix = cfg["index"]
    return dict(R=ix["R"], L=ix["L_build"], alpha=ix["alpha"])


def open_graph(cfg: dict, base: np.ndarray, seed: int, log=print, cache_dir=None):
    params = build_params(cfg)
    return index_cache.load_or_build(
        cfg["name"], seed, base, params,
        lambda: vamana.build_vamana(base, seed=seed, **params), log, cache_dir)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans, log=print,
                 cache_dir=None):
        self.cfg, self.traffic, self.seed, self.spans = cfg, traffic, seed, spans
        self.k = cfg["k"]
        self.base, self.pool = data.inputs(cfg, traffic, seed)
        self.index_seed = data.index_seed(cfg, seed)
        graph = open_graph(cfg, self.base, self.index_seed, log, cache_dir)
        qb = RabitQuantizer(cfg["d"], seed=self.index_seed).fit_encode(self.base)
        s = cfg["system"]
        sys_cfg = baselines.SystemConfig(
            buffer_ratio=s["buffer_ratio"], page_size=s["page_size"], batch_size=s["batch_size"],
            n_workers=s["n_workers"], device=device,
            params=SearchParams(k=self.k, L=s["L"], W=s["W"]))
        self.system = baselines.build_system(s["name"], self.base, graph, qb, sys_cfg)
        self.pool_obj = self.system.ctx.accessor.pool
        self._done: dict[int, float] = {}
        self._answered = 0  # answers of the window before the current call
        self.estimates: list[tuple[int, np.ndarray, np.ndarray]] = []
        make = self.system.make_coroutine
        done, estimates = self._done, self.estimates

        def make_coroutine(qid, q):
            inner, answer, value = make(qid, q), self._answered + qid, None
            while True:
                try:
                    op = inner.send(value)
                except StopIteration as fin:
                    done[qid] = time.perf_counter()
                    return fin.value
                value = yield op
                if op[0] == "score" and op[1].kind == "estimate":
                    estimates.append((answer, op[1].payload, np.array(value, dtype=np.float64)))

        self.system.make_coroutine = make_coroutine
        dist = self.system.ctx.dist
        for name in DIST_METHODS:
            if hasattr(dist, name):
                setattr(dist, name, spans.wrap(f"distance.{name}", getattr(dist, name)))
        self.pos = 0
        self.run_totals = dict.fromkeys(RUN_COUNTERS, 0)
        self.window: list[tuple[np.ndarray, list]] = []

    # ---- the timed path ---------------------------------------------------

    def call(self) -> list[float]:
        B = self.traffic["call_queries"]
        idx = (self.pos + np.arange(B)) % len(self.pool)
        self.pos += B
        self._done.clear()
        with self.spans.span("engine"):
            t0 = time.perf_counter()
            results, stats = self.system.run(self.pool[idx])
            t1 = time.perf_counter()
        for name in RUN_COUNTERS:
            self.run_totals[name] += getattr(stats, name)
        self.window.append((idx, results))
        self._answered += B
        return [self._done.get(i, t1) - t0 for i in range(B)]

    def warmup(self) -> int:
        """Calls until the record pool is full, ``min_warmup_calls`` at the
        least and ``max_warmup_calls`` at the most; the window continues the
        same stream."""
        t = self.traffic
        calls = 0
        while calls < t["max_warmup_calls"]:
            self.call()
            calls += 1
            full = self.pool_obj.occupancy() >= self.pool_obj.n_slots
            if full and calls >= t["min_warmup_calls"]:
                break
        return calls

    def begin_window(self) -> None:
        self.window.clear()
        self.estimates.clear()
        self._answered = 0

    def counters(self) -> dict:
        st = self.system.ctx.dist.stats
        out = dict(self.run_totals)
        out.update({f"distance.{f}": getattr(st, f) for f in DIST_COUNTERS})
        out["binary_ip.launches"] = bip_kernel.launches
        out["binary_ip.tensor_core_launches"] = bip_kernel.tensor_core_launches
        out["int4_dist.launches"] = i4_kernel.launches
        return out

    def launch_shapes(self) -> dict:
        return {}

    def answers(self) -> dict:
        qidx = np.concatenate([idx for idx, _ in self.window]) if self.window else np.zeros(0, int)
        res = []
        for idx, results in self.window:
            results = list(results)[:len(idx)]
            res += [None if r is None else (r.ids, r.dists) for r in results]
            res += [None] * (len(idx) - len(results))
        ids, dists = judge.stack(res, self.k)
        est = self.estimates
        got = [e if len(e) == len(i) else np.full(len(i), np.nan) for _, i, e in est]
        return dict(qidx=qidx, ids=ids, dists=dists,
                    est_answer=np.repeat([a for a, _, _ in est],
                                         [len(i) for _, i, _ in est]).astype(np.int64),
                    est_ids=np.concatenate([np.zeros(0, np.int64)] + [i for _, i, _ in est]),
                    est=np.concatenate([np.zeros(0)] + got))

    def release(self) -> None:
        """Free the port's state before the reference runs."""
        self.system = self.pool_obj = None
        self.window.clear()
        self.estimates.clear()

    # ---- after the window: the reference ----------------------------------

    def judge(self, ans: dict, device, control: bool = False) -> dict:
        """The compared numbers of ``ans`` (the port's answers and level-1
        estimates, or with ``control`` the reference's in a lower precision
        in their place: the answers in bf16, the estimates with the sign
        product in TF32), the per-answer failures and recall@k."""
        enc = rabitq.encode(self.base, self.index_seed)
        tables = rabitq.Tables(enc, device)
        qr = torch.from_numpy(rabitq.rotate(enc, self.pool[ans["qidx"]])).to(device)
        ids, dists = ans["ids"], ans["dists"]
        if control:
            ids, dists = exhaustive(tables, qr, self.k, torch.bfloat16)
        bad = judge.bad(ids, dists, self.cfg["n"])
        gap = judge.dist_gap(tables, qr, ids, dists)
        owner = torch.from_numpy(ans["est_answer"]).to(device)
        est_ids = torch.from_numpy(ans["est_ids"]).to(device)
        want, scale = rabitq.estimate_dist2(enc, qr, owner, est_ids)
        got = rabitq.estimate_dist2(enc, qr, owner, est_ids, control=True)[0] if control \
            else ans["est"]
        est_gap = judge.est_gap(got, want, scale, ans["est_answer"], len(ids))
        uniq, inv = np.unique(ans["qidx"], return_inverse=True)
        gt = exact.topk(self.base, self.pool[uniq], self.k, device)[inv]
        numbers = dict(bad_answers=int(bad.sum()), dist_gap=float(gap.max(initial=0.0)),
                       est_gap=float(est_gap.max(initial=0.0)))
        return dict(numbers=numbers, per_answer=dict(bad=bad, dist_gap=gap, est_gap=est_gap),
                    recall=judge.recall(ids, gt))


def exhaustive(tables: rabitq.Tables, qr: torch.Tensor, k: int, dtype, block: int = 16):
    """Every row's refined distance to each query in ``dtype``; the k
    smallest, equal values in lower-row order: (ids, dists) on the host."""
    n = tables.codes.shape[0]
    all_ids = torch.arange(n, device=qr.device)
    ids, ds = [], []
    for s in range(0, qr.shape[0], block):
        q = qr[s:s + block]
        d2 = rabitq.int4_dist2(tables, q, all_ids.expand(q.shape[0], n), dtype=dtype, block=block)
        d2s, order = torch.sort(d2, dim=1, stable=True)
        ids.append(order[:, :k].cpu())
        ds.append(d2s[:, :k].to(torch.float64).cpu())
    return torch.cat(ids).numpy(), torch.cat(ds).numpy()


