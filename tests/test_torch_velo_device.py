"""The port's ``velo`` device plane against the JAX package's.

One index image: the reference's ``DeviceIndex`` (from ``from_host`` on the
``small_qb`` / ``small_graph`` fixtures) carried into the port by
``convert.device_index_from_reference``.  On the CPU (``binary_ip``'s plain
version in the port, the reference's Pallas kernel in interpret mode):

  * ``batch_search`` and ``scan_search`` return identical ids and identical
    ``steps``, dist2 within rtol 1e-4 / atol 1e-3 (fp32 sums in another
    order), with one chunk, and streaming over chunks with and without a
    tail;
  * ``scan_search``'s stage-1 bf16 estimates of a chunk are bitwise the
    reference's, given the same unit queries;
  * the stable top-k picks what ``jax.lax.top_k`` picks on rows full of
    equal bf16 values;
  * the reference's own bars (tests/test_velo_device.py): recall, larger L
    never hurts, scan recall, scan >= graph, host distance semantics;
  * ``dist_search``'s mask and merge equal the reference's (mask before the
    offset), and a 2-rank gloo run equals the reference's per-shard scan,
    mask and merge on the same split.
"""

import dataclasses
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.dataset import recall_at_k  # noqa: E402
from repro.core.quant import RabitQuantizer  # noqa: E402
from repro.kernels.binary_ip.ops import binary_ip as ref_binary_ip  # noqa: E402
from repro.velo import batch_search as ref_bs  # noqa: E402
from repro.velo import dist_search as ref_ds  # noqa: E402
from repro.velo import scan_search as ref_ss  # noqa: E402
from repro.velo.index import from_host as ref_from_host  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.velo import batch_search as bs  # noqa: E402
from repro_torch.velo import dist_search as ds_mod  # noqa: E402
from repro_torch.velo import scan_search as ss  # noqa: E402
from repro_torch.velo.index import DeviceIndex, from_host, synthetic_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D2_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _arrays(index) -> dict:
    return {f.name: np.asarray(getattr(index, f.name)) for f in dataclasses.fields(index)}


@pytest.fixture(scope="module")
def ref_index(small_qb, small_graph):
    return ref_from_host(small_qb, small_graph)


@pytest.fixture(scope="module")
def dev_index(ref_index):
    return convert.device_index_from_reference(_arrays(ref_index), device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ against the reference


def test_from_host_builds_the_reference_image(small_qb, small_graph, ref_index, dev_index):
    mine = from_host(small_qb, small_graph, device="cpu")
    for f in dataclasses.fields(DeviceIndex):
        want = np.asarray(getattr(ref_index, f.name))
        for idx in (mine, dev_index):
            got = getattr(idx, f.name).numpy()
            assert got.shape == want.shape and np.array_equal(got, want), f.name
    n = mine.n
    assert (mine.n, mine.dim, mine.R) == (ref_index.n, ref_index.dim, ref_index.R)
    # the sentinel's norm squares to inf in fp32: it estimates to +inf
    assert torch.isinf(mine.norms[n] ** 2) and int(mine.adjacency[n].min()) == n


@pytest.mark.parametrize("L,max_steps,n_q", [(48, 96, 60), (16, 128, 30), (64, 40, 7)])
def test_batch_search_matches_reference(small_ds, ref_index, dev_index, L, max_steps, n_q):
    q = small_ds.queries[:n_q]
    want_ids, want_d2, want_steps = ref_bs.batch_search(ref_index, jnp.asarray(q), L=L, k=10,
                                                        max_steps=max_steps)
    ids, d2, steps = bs.batch_search(dev_index, _t(q), L=L, k=10, max_steps=max_steps)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(steps.numpy(), np.asarray(want_steps))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), **D2_TOL)
    assert ids.dtype == torch.int64 and d2.dtype == torch.float32 and steps.dtype == torch.int32


# chunk: one block (n <= chunk), a multiple of the chunk, chunks and a tail
@pytest.mark.parametrize("chunk,rerank", [(ss.DEFAULT_CHUNK, 64), (500, 64), (512, 96),
                                          (256, 32)])
def test_scan_search_matches_reference(small_ds, ref_index, dev_index, chunk, rerank):
    q = small_ds.queries
    want_ids, want_d2 = ref_ss.scan_search(ref_index, jnp.asarray(q), k=10, rerank=rerank,
                                           chunk=chunk)
    ids, d2 = ss.scan_search(dev_index, _t(q), k=10, rerank=rerank, chunk=chunk)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), **D2_TOL)
    # use_kernel=False takes binary_ip_ref: on the CPU the same product
    ids2, d22 = ss.scan_search(dev_index, _t(q), k=10, rerank=rerank, chunk=chunk,
                               use_kernel=False)
    assert torch.equal(ids2, ids) and torch.equal(d22, d2)


@pytest.mark.parametrize("lo,hi", [(0, 1500), (512, 1024), (1000, 1500)])
def test_stage1_estimates_are_bitwise_the_reference(small_ds, ref_index, dev_index, lo, hi):
    """One chunk's bf16 level-1 estimates, given the same unit queries: the
    reference's chain (scan_search.py's stage1_block: the Pallas binary_ip
    on bf16 queries, then bf16 ops with its casts) and the port's."""
    q = small_ds.queries[:8]
    qr = (q - np.asarray(ref_index.centroid)[None, :]) @ np.asarray(ref_index.rotation).T
    qnorm = np.linalg.norm(qr, axis=1, keepdims=True).astype(np.float32)
    qunit = (qr / np.maximum(qnorm, 1e-12)).astype(np.float32)
    d = qunit.shape[1]

    @jax.jit
    def ref_stage1(qunit, qnorm, codes_blk, norms_blk, ipb_blk):
        g = ref_binary_ip(qunit.astype(jnp.bfloat16), codes_blk, interpret=True)
        g = (g / jnp.sqrt(jnp.float32(d))).astype(jnp.bfloat16)
        ipb = jnp.maximum(ipb_blk[None, :], 1e-6).astype(jnp.bfloat16)
        est_cos = jnp.clip(g / ipb, -1.0, 1.0)
        nr = norms_blk[None, :].astype(jnp.bfloat16)
        qn = qnorm.astype(jnp.bfloat16)
        return qn**2 + nr**2 - 2.0 * qn * nr * est_cos

    want = np.asarray(ref_stage1(qunit, qnorm, ref_index.binary_codes[lo:hi],
                                 ref_index.norms[lo:hi], ref_index.ip_bar[lo:hi]))
    got = ss.stage1_block(_t(qunit), _t(qnorm), dev_index.binary_codes[lo:hi],
                          dev_index.norms[lo:hi], dev_index.ip_bar[lo:hi])
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("seed,levels", [(0, 4), (1, 16), (2, 1)])
def test_stable_topk_picks_what_lax_top_k_picks(seed, levels):
    """Rows of bf16 values drawn from a few levels tie massively; the port's
    stable ascending sort and cut selects the same (value, index) pairs in
    the same order as jax.lax.top_k of the negated values."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, levels, (8, 4096)) * 0.25 + 1.0).astype(np.float32)
    xt = _t(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    for k in (1, 10, 64, 4096):
        neg, sel = jax.lax.top_k(-xj, k)
        vals, idx = ss.smallest(xt, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(sel))
        np.testing.assert_array_equal(vals.float().numpy(), -np.asarray(neg, np.float32))


# ------------------------------------------------- the reference's own bars


def test_batch_search_recall(small_ds, dev_index):
    ids, d2, steps = bs.batch_search(dev_index, _t(small_ds.queries), L=48, k=10, max_steps=96)
    rec = recall_at_k(ids.numpy(), small_ds.groundtruth, 10)
    assert rec > 0.6, f"device graph search recall {rec}"
    assert bool((steps > 3).all()) and bool(torch.isfinite(d2).all())


def test_batch_search_larger_L_never_hurts(small_ds, dev_index):
    rs = {}
    for L in (16, 64):
        ids, _, _ = bs.batch_search(dev_index, _t(small_ds.queries[:30]), L=L, k=10,
                                    max_steps=128)
        rs[L] = recall_at_k(ids.numpy(), small_ds.groundtruth[:30], 10)
    assert rs[64] >= rs[16]


def test_scan_search_recall(small_ds, dev_index):
    ids, _ = ss.scan_search(dev_index, _t(small_ds.queries), k=10, rerank=64)
    rec = recall_at_k(ids.numpy(), small_ds.groundtruth, 10)
    assert rec > 0.8, f"scan recall {rec}"


def test_scan_beats_graph_recall(small_ds, dev_index):
    q = _t(small_ds.queries[:40])
    ids_g, _, _ = bs.batch_search(dev_index, q, L=48, k=10, max_steps=96)
    ids_s, _ = ss.scan_search(dev_index, q, k=10, rerank=96)
    gt = small_ds.groundtruth[:40]
    assert recall_at_k(ids_s.numpy(), gt, 10) >= recall_at_k(ids_g.numpy(), gt, 10) - 0.02


def test_device_matches_host_distance_semantics(small_ds, small_qb, dev_index):
    ids, d2, _ = bs.batch_search(dev_index, _t(small_ds.queries[:4]), L=32, k=5, max_steps=64)
    for i in range(4):
        pq = RabitQuantizer.prepare_query(small_qb, small_ds.queries[i])
        host = RabitQuantizer.refine_dist2(small_qb, pq, ids[i].numpy())
        np.testing.assert_allclose(d2[i].numpy(), host, rtol=2e-3, atol=2e-3)


def test_synthetic_specs_allocate_nothing():
    spec = synthetic_specs(n=1_000_000, d=128, R=32)
    assert spec.binary_codes.is_meta and spec.adjacency.is_meta
    assert (spec.n, spec.dim, spec.R) == (1_000_000, 128, 32)
    assert spec.binary_codes.shape == (1_000_001, 16) and spec.ext_codes.shape == (1_000_001, 64)
    assert spec.medoid.shape == () and spec.norms.dtype == torch.float32


def test_search_on_the_card_by_default_raises_without_one(small_qb, small_graph):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_host(small_qb, small_graph)


# -------------------------------------------------------------- dist_search


def test_mask_and_merge_match_reference_and_mask_before_offset():
    """An under-filled shard pads its local top-k with id -1 lanes carrying
    garbage distances: they are masked BEFORE the offset (offset - 1 would
    be a valid-looking id of the previous shard) and never win the merge."""
    ids0, d20 = [[0, 1, 2]], [[0.1, 0.2, 0.3]]
    ids1, d21 = [[4, -1, -1]], [[0.05, 0.0, 0.0]]
    got = [ds_mod.mask_local_topk(torch.tensor(i), torch.tensor(d), off)
           for i, d, off in ((ids0, d20, 0), (ids1, d21, 100))]
    want = [ref_ds.mask_local_topk(jnp.array(i), jnp.array(d, jnp.float32), jnp.int32(off))
            for i, d, off in ((ids0, d20, 0), (ids1, d21, 100))]
    assert got[1][0].tolist() == [[104, -1, -1]]
    for (g, gd), (w, wd) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    gids = torch.cat([got[0][0], got[1][0]], dim=1)
    d2 = torch.cat([got[0][1], got[1][1]], dim=1)
    for k in (3, 6):
        out_ids, out_d2 = ds_mod.merge_topk(gids, d2, k)
        w_ids, w_d2 = ref_ds.merge_topk(jnp.asarray(gids.numpy()), jnp.asarray(d2.numpy()), k)
        np.testing.assert_array_equal(out_ids.numpy(), np.asarray(w_ids))
        np.testing.assert_array_equal(out_d2.numpy(), np.asarray(w_d2))
    out_ids, out_d2 = ds_mod.merge_topk(gids, d2, 3)
    assert out_ids.tolist() == [[104, 0, 1]]
    out_ids6, out_d26 = ds_mod.merge_topk(gids, d2, 6)
    assert torch.isinf(out_d26[0, 4:]).all() and out_ids6[0, :4].tolist() == [104, 0, 1, 2]


def test_merge_ties_keep_the_earlier_shard_first():
    gids = torch.tensor([[5, 6, 105, 106]])
    d2 = torch.tensor([[1.0, 2.0, 1.0, 0.5]])
    out_ids, _ = ds_mod.merge_topk(gids, d2, 3)
    w_ids, _ = ref_ds.merge_topk(jnp.asarray(gids.numpy()), jnp.asarray(d2.numpy()), 3)
    assert out_ids.tolist() == np.asarray(w_ids).tolist() == [[106, 5, 105]]


_RANKS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, port, data, out):
        torch.set_num_threads(1)
        from repro_torch import convert
        from repro_torch.velo import dist_search
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        try:
            z = np.load(data)
            fields = {k[len(f"s{rank}_"):]: z[k] for k in z.files if k.startswith(f"s{rank}_")}
            index = convert.device_index_from_reference(fields, device="cpu")
            search = dist_search.make_distributed_search(mode="scan", L=32, k=10)
            ids, d2 = search(index, int(z["offsets"][rank]), torch.from_numpy(z["queries"]))
            if rank == 0:
                np.savez(out, ids=ids.numpy(), d2=d2.numpy())
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, int(sys.argv[1]), sys.argv[2],
                                                      sys.argv[3]))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(150)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        sys.exit(1 if alive or any(p.exitcode for p in procs) else 0)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_search_equals_per_shard_reference(small_ds, small_qb, tmp_path):
    """Two ranks, each holding half of the index as its own DeviceIndex:
    the all_gather merge returns what the reference's per-shard scan_search,
    mask_local_topk and merge_topk return on the same split."""
    n = small_qb.norms.shape[0]
    cut = [0, 700, n]
    q = small_ds.queries[:12]
    arrays, parts = {}, []
    for r in range(2):
        rows = slice(cut[r], cut[r + 1])
        shard_qb = dataclasses.replace(
            small_qb, **{f: getattr(small_qb, f)[rows] for f in (
                "binary_codes", "norms", "ip_bar", "ext_codes", "ext_lo", "ext_step")})
        m = cut[r + 1] - cut[r]
        graph = types.SimpleNamespace(adjacency=np.full((m, 1), -1, np.int32), medoid=0)
        shard = ref_from_host(shard_qb, graph)  # a scan reads no adjacency
        arrays.update({f"s{r}_{k}": v for k, v in _arrays(shard).items()})
        ids, d2 = ref_ss.scan_search(shard, jnp.asarray(q), k=10, rerank=32)
        parts.append(ref_ds.mask_local_topk(ids, d2, jnp.int32(cut[r])))
    want_ids, want_d2 = ref_ds.merge_topk(jnp.concatenate([p[0] for p in parts], axis=1),
                                          jnp.concatenate([p[1] for p in parts], axis=1), 10)
    data, out, script = tmp_path / "shards.npz", tmp_path / "out.npz", tmp_path / "ranks.py"
    np.savez(data, offsets=np.asarray(cut[:2]), queries=q, **arrays)
    script.write_text(_RANKS)
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, str(script), str(_free_port()), str(data), str(out)],
                          env=env, capture_output=True, text=True, timeout=200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(out)
    np.testing.assert_array_equal(got["ids"], np.asarray(want_ids))
    np.testing.assert_allclose(got["d2"], np.asarray(want_d2), **D2_TOL)
