"""The port's paged KV pool + cache-aware scheduler against the JAX package.

The six tests of tests/test_kv_serving.py run on the port's pool on the
CPU.  A lockstep test drives one seeded sequence of operations through the
reference's ``PagedKVPool``/``CacheAwareScheduler`` and the port's and
requires identical bookkeeping and bitwise-equal pages after every step; a
carry-over test hands a reference pool mid-run to the port through
``convert.kv_pool_from_reference`` and continues both in lockstep.  A third
runs chip_smoke.py's kv serve mix through both, shows a batch's block tables
going stale in each, and the port's ``batch_block_tables`` rebuilding them.
Attention over the pools is held within rtol/atol 2e-3 (fp32 sums in
another order, the bar of tests/test_kernels.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import kv_pool_from_reference
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.serving.kv_pool import MARKED, PagedKVPool
from repro_torch.serving.scheduler import CacheAwareScheduler, ServeRequest

RNG = np.random.default_rng(0)
TOL = dict(rtol=2e-3, atol=2e-3)


def _pool(*args, **kw) -> PagedKVPool:
    return PagedKVPool(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's pool, scheduler and paged attention op."""
    pytest.importorskip("jax")
    from repro.kernels.paged_attention import paged_attention as j_paged
    from repro.serving.kv_pool import PagedKVPool as JPool
    from repro.serving.scheduler import CacheAwareScheduler as JSched
    from repro.serving.scheduler import ServeRequest as JReq

    return dict(paged=j_paged, Pool=JPool, Sched=JSched, Req=JReq)


# ------------------------------------------- tests/test_kv_serving.py, ported


def test_append_and_block_tables():
    pool = _pool(n_pages=8, page_size=4, kv_heads=2, head_dim=8)
    pool.add_request(0)
    for t in range(10):  # spans 3 pages
        pool.append_token(0, RNG.standard_normal((2, 8)), RNG.standard_normal((2, 8)))
    req = pool.requests[0]
    assert req.context_len == 10
    assert len(req.block_table) == 3
    bt = pool.block_table_array(0, max_pages=4)
    assert (bt[:3] >= 0).all()


def test_eviction_spills_and_reloads_exactly():
    pool = _pool(n_pages=4, page_size=2, kv_heads=1, head_dim=4)
    pool.add_request(0)
    kept = []
    for t in range(8):  # needs 4 pages — fills the pool
        k = RNG.standard_normal((1, 4)).astype(np.float32)
        kept.append(k.copy())
        pool.append_token(0, k, k)
    pool.add_request(1)
    pool.append_token(1, RNG.standard_normal((1, 4)), RNG.standard_normal((1, 4)))
    assert pool.evictions >= 1
    # some page of request 0 was swapped out; reload and verify bytes
    req0 = pool.requests[0]
    swapped = [lp for lp, pp in enumerate(req0.block_table) if pp < 0]
    assert swapped
    lp = swapped[0]
    pp = pool.ensure_resident(0, lp)
    np.testing.assert_array_equal(pool.k_pages[pp, 0].numpy(), kept[lp * 2])
    assert pool.swap_ins >= 1


def test_second_chance_protects_hot_request():
    pool = _pool(n_pages=4, page_size=2, kv_heads=1, head_dim=4)
    pool.add_request(0)
    pool.add_request(1)
    for _ in range(4):
        pool.append_token(0, np.ones((1, 4)), np.ones((1, 4)))  # 2 pages
        pool.append_token(1, np.zeros((1, 4)), np.zeros((1, 4)))
    # touch request 0's pages (hot), then force an eviction via request 2
    for lp in range(len(pool.requests[0].block_table)):
        pool.ensure_resident(0, lp)
    pool.state[:] = MARKED  # one full sweep
    for lp in range(len(pool.requests[0].block_table)):
        pool.ensure_resident(0, lp)  # second chance for request 0
    pool.add_request(2)
    pool.append_token(2, np.full((1, 4), 2.0), np.full((1, 4), 2.0))
    assert all(p >= 0 for p in pool.requests[0].block_table), "hot request evicted"
    assert any(p < 0 for p in pool.requests[1].block_table), "cold request kept"


def test_scheduler_prefers_resident_requests():
    pool = _pool(n_pages=6, page_size=2, kv_heads=1, head_dim=4)
    sched = CacheAwareScheduler(pool, max_batch=2, age_boost=3)
    for rid in range(3):
        sched.submit(ServeRequest(rid=rid, prompt_len=4, max_new_tokens=6))
    # admit and build contexts: rids 0,1 hot; rid 2 swapped out
    sched.next_batch()
    for req in sched.running.values():
        for _ in range(4):
            pool.append_token(req.rid, np.ones((1, 4)), np.ones((1, 4)))
    # force rid 2's pages out
    for lp, pp in enumerate(pool.requests[2].block_table):
        if pp >= 0:
            pool.state[pp] = MARKED
    pool.add_request(99)
    pool.append_token(99, np.zeros((1, 4)), np.zeros((1, 4)))
    batch = sched.next_batch()
    rids = {r.rid for r in batch}
    assert 2 not in rids or pool.residency_fraction(2) == 1.0
    # starvation guard: within age_boost steps rid 2 must get scheduled
    seen_2 = False
    for _ in range(5):
        batch = sched.next_batch()
        seen_2 |= any(r.rid == 2 for r in batch)
    assert seen_2


def test_pool_drives_paged_attention_kernel(jref):
    """End to end: tokens appended through the pool, attention through the
    port's op via the pool's block tables == the JAX Pallas op on the same
    pages == dense attention over the appended tokens."""
    P_, page, KVH, Dh, B, H = 8, 4, 2, 16, 2, 4
    pool = _pool(n_pages=P_, page_size=page, kv_heads=KVH, head_dim=Dh)
    ctx = [7, 5]
    dense_k = [np.zeros((c, KVH, Dh), np.float32) for c in ctx]
    dense_v = [np.zeros((c, KVH, Dh), np.float32) for c in ctx]
    for b in range(B):
        pool.add_request(b)
        for t in range(ctx[b]):
            k = RNG.standard_normal((KVH, Dh)).astype(np.float32)
            v = RNG.standard_normal((KVH, Dh)).astype(np.float32)
            dense_k[b][t], dense_v[b][t] = k, v
            pool.append_token(b, k, v)

    max_pages = 2
    bt = np.stack([pool.block_table_array(b, max_pages) for b in range(B)])
    q = RNG.standard_normal((B, H, Dh)).astype(np.float32)
    cl = np.asarray(ctx, np.int32)
    out = paged_attention(torch.from_numpy(q), pool.k_pages, pool.v_pages,
                          torch.from_numpy(bt), torch.from_numpy(cl)).numpy()
    want = jref["paged"](q, pool.k_pages.numpy(), pool.v_pages.numpy(), bt, cl)
    np.testing.assert_allclose(out, np.asarray(want), **TOL)
    for b in range(B):
        kk = np.repeat(dense_k[b], H // KVH, axis=1)          # (S, H, Dh)
        logits = np.einsum("hd,shd->hs", q[b], kk) * Dh**-0.5
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        dense = np.einsum("hs,shd->hd", p, np.repeat(dense_v[b], H // KVH, axis=1))
        np.testing.assert_allclose(out[b], dense, **TOL)


def test_serving_loop_completes_all_requests():
    pool = _pool(n_pages=16, page_size=2, kv_heads=1, head_dim=4)
    sched = CacheAwareScheduler(pool, max_batch=3)
    for rid in range(7):
        sched.submit(ServeRequest(rid=rid, prompt_len=2, max_new_tokens=4))
    steps = 0
    while not sched.idle and steps < 200:
        batch = sched.next_batch()
        for req in batch:  # "decode": append one token per scheduled request
            pool.append_token(req.rid, np.ones((1, 4)), np.ones((1, 4)))
        sched.complete_step(batch)
        steps += 1
    assert sched.idle
    assert sorted(sched.completed) == list(range(7))


# ------------------------------------------------- lockstep with the reference


def _assert_same(jp, tp, where: str) -> None:
    assert np.array_equal(jp.state, tp.state), where
    assert np.array_equal(jp.owner, tp.owner), where
    assert jp.hand == tp.hand, where
    assert {r: (q.block_table, q.context_len) for r, q in jp.requests.items()} == \
        {r: (q.block_table, q.context_len) for r, q in tp.requests.items()}, where
    assert (jp.hits, jp.misses, jp.evictions, jp.swap_ins) == \
        (tp.hits, tp.misses, tp.evictions, tp.swap_ins), where
    assert np.array_equal(jp.k_pages, tp.k_pages.numpy()), where
    assert np.array_equal(jp.v_pages, tp.v_pages.numpy()), where
    assert jp.swap.keys() == tp.swap.keys(), where
    for key, (k, v) in jp.swap.items():
        assert tp.swap[key][0].device.type == "cpu", where
        assert np.array_equal(k, tp.swap[key][0].numpy()), where
        assert np.array_equal(v, tp.swap[key][1].numpy()), where


def _random_ops(jp, tp, rng, n_ops: int, next_rid: int, where: str) -> int:
    """Apply ``n_ops`` seeded pool operations to both pools, checking after
    each; returns the next unused request id."""
    kvh, dh = jp.k_pages.shape[2:]
    for i in range(n_ops):
        live = sorted(jp.requests)
        op = rng.choice(["add", "append", "append", "append", "ensure", "evict",
                         "finish", "table"]) if live else "add"
        tag = f"{where} op {i} {op}"
        if op == "add":
            for p in (jp, tp):
                p.add_request(next_rid)
            next_rid += 1
        elif op == "append":
            rid = int(rng.choice(live))
            k, v = rng.standard_normal((kvh, dh)), rng.standard_normal((kvh, dh))
            for p in (jp, tp):
                p.append_token(rid, k, v)
        elif op in ("ensure", "table"):
            rid = int(rng.choice(live))
            n = len(jp.requests[rid].block_table)
            if n == 0:
                continue
            if op == "ensure":
                lp = int(rng.integers(0, n))
                assert jp.ensure_resident(rid, lp) == tp.ensure_resident(rid, lp), tag
            else:
                assert np.array_equal(jp.block_table_array(rid, n + 1),
                                      tp.block_table_array(rid, n + 1)), tag
        elif op == "evict":  # a forced eviction: every page marked, one sweep
            if (jp.state == 0).all():
                continue
            for p in (jp, tp):
                p.state[p.state != 0] = MARKED
            assert jp._clock_evict() == tp._clock_evict(), tag
        elif op == "finish":
            rid = int(rng.choice(live))
            for p in (jp, tp):
                p.finish_request(rid)
        _assert_same(jp, tp, tag)
    return next_rid


def _attend_both(jp, tp, jref, rng):
    rids = sorted(r for r, q in jp.requests.items() if q.context_len > 0)
    if not rids:
        return
    max_pages = max(len(jp.requests[r].block_table) for r in rids)
    bt_j = np.stack([jp.block_table_array(r, max_pages) for r in rids])
    bt_t = np.stack([tp.block_table_array(r, max_pages) for r in rids])
    assert np.array_equal(bt_j, bt_t)
    _assert_same(jp, tp, "block tables for attention")
    cl = np.asarray([jp.requests[r].context_len for r in rids], np.int32)
    kvh, dh = jp.k_pages.shape[2:]
    q = rng.standard_normal((len(rids), 2 * kvh, dh)).astype(np.float32)
    want = np.asarray(jref["paged"](q, jp.k_pages, jp.v_pages, bt_j, cl))
    got = paged_attention(torch.from_numpy(q), tp.k_pages, tp.v_pages,
                          torch.from_numpy(bt_t), torch.from_numpy(cl)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lockstep_with_reference_pool_and_scheduler(jref):
    rng = np.random.default_rng(12)
    jp = jref["Pool"](n_pages=6, page_size=2, kv_heads=2, head_dim=8)
    tp = _pool(n_pages=6, page_size=2, kv_heads=2, head_dim=8)
    next_rid = _random_ops(jp, tp, rng, 120, 0, "pool")
    assert jp.evictions > 0 and jp.swap_ins > 0
    _attend_both(jp, tp, jref, rng)

    # continuous batching under oversubscription: 9 requests, 4 live, 2 a step
    js = jref["Sched"](jp, max_batch=2, age_boost=3, max_running=4)
    ts = CacheAwareScheduler(tp, max_batch=2, age_boost=3, max_running=4)
    for rid in range(next_rid, next_rid + 9):
        n_new = int(rng.integers(2, 6))
        js.submit(jref["Req"](rid=rid, prompt_len=3, max_new_tokens=n_new))
        ts.submit(ServeRequest(rid=rid, prompt_len=3, max_new_tokens=n_new))
    evictions0 = jp.evictions
    for step in range(200):
        if js.idle:
            break
        jb, tb = js.next_batch(), ts.next_batch()
        assert [r.rid for r in jb] == [r.rid for r in tb], step
        for jr in jb:
            k, v = rng.standard_normal((2, 8)), rng.standard_normal((2, 8))
            jp.append_token(jr.rid, k, v)
            tp.append_token(jr.rid, k, v)
        for jr in jb:
            n = len(jp.requests[jr.rid].block_table)
            assert np.array_equal(jp.block_table_array(jr.rid, n), tp.block_table_array(jr.rid, n))
        js.complete_step(jb)
        ts.complete_step(tb)
        assert js.completed == ts.completed and js.starved == ts.starved, step
        _assert_same(jp, tp, f"scheduler step {step}")
        if step % 4 == 3:
            _attend_both(jp, tp, jref, rng)
    assert js.idle and ts.idle and jp.evictions > evictions0


def _settled(pool, rids, tables) -> bool:
    """Whether every row of ``tables`` still equals its request's block table."""
    return all(np.array_equal(t[: len(pool.requests[r].block_table)], pool.requests[r].block_table)
               for r, t in zip(rids, tables))


def test_batch_tables_go_stale_and_batch_block_tables_rebuilds_them(jref):
    """chip_smoke.py's kv serve mix at narrow widths (the bookkeeping does
    not depend on them): 1 024 pages of 16 tokens, 48 requests with seeded
    prompts of 512-2048 and 32-64 new tokens, max_batch 8, max_running 16.
    In both packages a batch's tables built one request at a time go stale
    (a later request's swap-in evicts a page an earlier table names); the
    port's ``batch_block_tables`` builds them again until they hold, and the
    reference given the same calls stays in lockstep.  The counts are the
    ones the kv serve phase reports on the card."""
    rng = np.random.default_rng(0)
    prompt_lens, new_tokens = rng.integers(512, 2049, 48), rng.integers(32, 65, 48)
    jp = jref["Pool"](n_pages=1024, page_size=16, kv_heads=1, head_dim=4)
    tp = _pool(n_pages=1024, page_size=16, kv_heads=1, head_dim=4)
    js = jref["Sched"](jp, max_batch=8, max_running=16)
    ts = CacheAwareScheduler(tp, max_batch=8, max_running=16)
    for rid in range(48):
        js.submit(jref["Req"](rid, int(prompt_lens[rid]), int(new_tokens[rid])))
        ts.submit(ServeRequest(rid, int(prompt_lens[rid]), int(new_tokens[rid])))
    kv = np.ones((1, 4), np.float32)
    steps = stale = j_repasses = 0
    while not ts.idle:
        jb, tb = js.next_batch(), ts.next_batch()
        rids = [r.rid for r in tb]
        assert [r.rid for r in jb] == rids, steps
        for pool, sched, batch in ((jp, js, jb), (tp, ts, tb)):
            for req in sched.running.values():  # prefill the admitted prompts
                if pool.requests[req.rid].context_len == 0:
                    for _ in range(req.prompt_len):
                        pool.append_token(req.rid, kv, kv)
            for req in batch:
                pool.append_token(req.rid, kv, kv)
        max_pages = max(len(jp.requests[r].block_table) for r in rids)
        tables = np.stack([jp.block_table_array(r, max_pages) for r in rids])
        stale += not _settled(jp, rids, tables)
        while not _settled(jp, rids, tables):  # the reference's caller, by hand
            tables = np.stack([jp.block_table_array(r, max_pages) for r in rids])
            j_repasses += 1
        got = tp.batch_block_tables(rids, max_pages)
        assert np.array_equal(got, tables) and _settled(tp, rids, got), steps
        assert tp.table_repasses == j_repasses, steps
        assert (jp.hand, jp.hits, jp.misses, jp.evictions) == \
            (tp.hand, tp.hits, tp.misses, tp.evictions), steps
        js.complete_step(jb)
        ts.complete_step(tb)
        steps += 1
    assert js.idle and js.completed == ts.completed
    _assert_same(jp, tp, "after the kv serve mix")
    assert (steps, tp.evictions, tp.swap_ins, stale, tp.table_repasses) == \
        (321, 34417, 34417, 25, 25)


def test_carry_over_from_reference_pool(jref):
    rng = np.random.default_rng(3)
    jp = jref["Pool"](n_pages=5, page_size=2, kv_heads=1, head_dim=8)
    for rid in range(3):
        jp.add_request(rid)
    for _ in range(14):  # 3 x ~5 tokens over 5 two-token pages: evictions
        rid = int(rng.integers(0, 3))
        jp.append_token(rid, rng.standard_normal((1, 8)), rng.standard_normal((1, 8)))
    assert jp.evictions > 0 and jp.swap
    fields = dict(k_pages=jp.k_pages, v_pages=jp.v_pages, state=jp.state, owner=jp.owner,
                  hand=jp.hand, swap=dict(jp.swap),
                  requests={r: (q.block_table, q.context_len) for r, q in jp.requests.items()},
                  hits=jp.hits, misses=jp.misses, evictions=jp.evictions, swap_ins=jp.swap_ins)
    tp = kv_pool_from_reference(fields, device="cpu")
    _assert_same(jp, tp, "after the carry-over")
    assert not np.shares_memory(tp.k_pages.numpy(), jp.k_pages)
    _random_ops(jp, tp, rng, 80, 3, "carried")
    _attend_both(jp, tp, jref, rng)

    with pytest.raises(ValueError):
        kv_pool_from_reference({**fields, "state": jp.state.astype(np.int64)}, device="cpu")
    with pytest.raises(ValueError):
        kv_pool_from_reference({k: v for k, v in fields.items() if k != "hand"}, device="cpu")


# ----------------------------------------------------------- on the card


@pytest.mark.cuda
def test_card_pool_drives_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    pool = PagedKVPool(n_pages=16, page_size=16, kv_heads=4, head_dim=128,
                       dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for rid, n in enumerate((100, 140, 90)):  # 22 pages over 16: evictions
        pool.add_request(rid)
        kv = torch.randn(n, 2, 4, 128, generator=gen, device=dev)
        for t in range(n):
            pool.append_token(rid, kv[t, 0], kv[t, 1])
    assert pool.evictions > 0
    assert all(k.device.type == "cpu" for k, _ in pool.swap.values())
    rids = [0, 2]
    max_pages = max(len(pool.requests[r].block_table) for r in rids)
    bt = torch.from_numpy(pool.batch_block_tables(rids, max_pages)).to(dev)
    cl = torch.tensor([pool.requests[r].context_len for r in rids], dtype=torch.int32, device=dev)
    assert pool.swap_ins > 0
    q = torch.randn(2, 32, 128, generator=gen, device=dev).to(torch.bfloat16)
    n0 = paged_kernel.launches
    got = paged_attention(q, pool.k_pages, pool.v_pages, bt, cl)
    assert paged_kernel.launches == n0 + 1
    want = paged_attention_ref(q, pool.k_pages, pool.v_pages, bt, cl)
    # one bf16 ulp: both compute in fp32 and round the output once
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=1e-2, atol=1e-4)
