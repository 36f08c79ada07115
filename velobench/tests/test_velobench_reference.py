"""The reference against brute force and against the frozen copies'
originals: exact top-k, the RaBitQ tables, the refined distance, the
scan's answers, the generator."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from velobench import data, judge  # noqa: E402
from velobench.reference import exact, rabitq, scan  # noqa: E402


@pytest.mark.parametrize("k", [1, 10])
def test_exact_topk_is_brute_force(k):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((700, 24)).astype(np.float32)
    q = rng.standard_normal((33, 24)).astype(np.float32)
    d2 = ((q[:, None, :].astype(np.float64) - base[None].astype(np.float64)) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :k]
    got = exact.topk(base, q, k, "cpu", block_bytes=4096 * 20)
    np.testing.assert_array_equal(got, want)


def test_generator_is_make_datasets():
    from repro_torch.core.dataset import make_dataset

    ds = make_dataset(n=900, d=16, n_queries=50, seed=2**31 + 3)
    base, pool = data.generate(900, 16, 50, 2**31 + 3)
    np.testing.assert_array_equal(base, ds.base)
    np.testing.assert_array_equal(pool, ds.queries)


def test_encoding_is_the_quantizers_bits():
    from repro_torch.core.quant import RabitQuantizer, unpack_bits, unpack_nibbles

    base, _ = data.generate(800, 32, 4, 11)
    qb = RabitQuantizer(32, seed=11).fit_encode(base)
    enc = rabitq.encode(base, 11)
    np.testing.assert_array_equal(enc.codes, unpack_nibbles(qb.ext_codes, 32))
    np.testing.assert_array_equal(enc.signs, unpack_bits(qb.binary_codes, 32).astype(bool))
    for name in ("centroid", "rotation", "norms", "ip_bar"):
        np.testing.assert_array_equal(getattr(enc, name), getattr(qb, name))
    np.testing.assert_array_equal(enc.lo, qb.ext_lo)
    np.testing.assert_array_equal(enc.step, qb.ext_step)


def test_int4_dist2_is_the_decoded_distance():
    base, pool = data.generate(300, 16, 5, 4)
    enc = rabitq.encode(base, 4)
    qr = rabitq.rotate(enc, pool)
    ids = np.arange(40).reshape(5, 8)
    x = enc.codes.astype(np.float64) * enc.step[:, None] + enc.lo[:, None]
    want = ((qr[:, None, :] - x[ids]) ** 2).sum(-1)
    got = rabitq.int4_dist2(rabitq.Tables(enc, "cpu"), torch.from_numpy(qr),
                            torch.from_numpy(ids), block=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    low = rabitq.int4_dist2(rabitq.Tables(enc, "cpu"), torch.from_numpy(qr),
                            torch.from_numpy(ids), dtype=torch.bfloat16).float().numpy()
    assert 1e-4 < np.max(np.abs(low - want) / want) < 5e-2


def test_scan_reference_answers_as_the_ports_scan():
    from repro_torch.core.quant import RabitQuantizer
    from repro_torch.velo import index as velo_index
    from repro_torch.velo.scan_search import scan_search
    import types

    base, pool = data.generate(3000, 32, 40, 5)
    qb = RabitQuantizer(32, seed=5).fit_encode(base)
    idx = velo_index.from_host(qb, types.SimpleNamespace(
        adjacency=np.full((3000, 4), -1, np.int32), medoid=0), device="cpu")
    ids, d2 = scan_search(idx, torch.from_numpy(pool), k=10, rerank=64, chunk=1024)
    t = scan.ScanTables(rabitq.encode(base, 5), "cpu")
    want, want_d = scan.scan(t, pool, 10, 64)
    assert judge.id_mismatch(ids.numpy(), want) <= 0.01
    same = ids.numpy() == want
    np.testing.assert_allclose(d2.numpy()[same], want_d[same], rtol=1e-5)
    c_ids, c_d = scan.scan(t, pool, 10, 64, control=True)
    assert judge.bad(c_ids, c_d, 3000).sum() == 0


def test_judge_marks_bad_answers():
    ids = np.array([[0, 1, 2], [0, 0, 2], [0, 1, 9], [0, 1, 2], [-1, 1, 2]])
    ds = np.array([[1.0, 2, 3], [1, 2, 3], [1, 2, 3], [3, 2, 1], [1, 2, 3]])
    np.testing.assert_array_equal(judge.bad(ids, ds, 5), [False, True, True, True, True])
    ids2, ds2 = judge.stack([None, (np.array([4, 3]), np.array([0.5, 0.6]))], 3)
    assert judge.bad(ids2, ds2, 5).tolist() == [True, True]
    assert judge.id_mismatch(np.array([[1, 2], [3, 4]]), np.array([[2, 1], [3, 5]])) == 0.25
    assert judge.recall(np.array([[1, 2], [3, 4]]), np.array([[2, 1], [3, 5]])) == 0.75
    ok, checks = judge.verdict({"a": 0, "b": 1e-3}, {"a": 0, "b": 1e-4})
    assert not ok and checks["b"] == {"value": 1e-3, "limit": 1e-4}
    assert not judge.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert not judge.verdict({}, {"a": 1.0})[0]
