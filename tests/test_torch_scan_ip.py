"""Inner-product search on the port's scan: ``RabitQuantizer(d, metric="ip")``
-> ``velo.index.from_host`` -> ``scan_search``, held against the plain
reference ``velo/reference_ip.py`` on seeded data (n 3 000, d 200 padded to
D 224, B 16).

On the CPU:
  * the padded encoding: an orthonormal D x D rotation, zeros past d in the
    centroid, codes over D, ``cr`` within float32 rounding of float64, and
    the reference's encoding bit for bit; the squared-L2 encoding is the JAX
    package's bit for bit at every d (no padding);
  * ``scan_search`` returns the reference's ids exactly, at one chunk,
    chunks, and chunks with a tail, for rerank 32 and 64, and its scores
    within ``SCORE_REL`` of the terms they sum, from the reference's float64
    scores;
    ``use_kernel=False`` gives the same answers;
  * stage 1's bf16 ranks of a chunk are the reference's bit for bit;
  * the sentinel row ranks last; ``batch_search`` refuses an inner-product
    index; the three ``scan.*`` spans are recorded.
On a card only: the inner-product ``scan_select`` equals its plain chain bit
for bit on full and tail chunks, ``binary_ip`` at D 224 takes the tensor
cores on every chunk, and ``scan_search`` on the card equals its plain chain.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core import quant as ref_quant
from repro_torch import convert, tracing
from repro_torch.configs import text2image, veloann
from repro_torch.core.quant import RabitQuantizer, padded_dim
from repro_torch.kernels.binary_ip import kernel as bip_kernel
from repro_torch.kernels.scan_select import kernel as sel_kernel
from repro_torch.kernels.scan_select import ref as sel_ref
from repro_torch.velo import batch_search as bs
from repro_torch.velo import reference_ip
from repro_torch.velo import scan_search as ss
from repro_torch.velo.index import from_host, synthetic_specs

# the deployment's reduced shape: n 3 000, d 200 (D 224), B 16
N, D_IN, B = (text2image.REDUCED.corpus_size, text2image.REDUCED.dim,
              text2image.REDUCED.query_batch)
SEED = 7
# The port's score is -((<q, c> + <qr, x>) + cr) in float32, the reference's
# the same in float64: each of the three terms is within a few float32 ulps
# (6e-8 each) of its exact value, <qr, x> a sum of 224 products, so the gap
# is within 1e-6 of the terms' size |<q, c>| + |qr| |o - c| + |cr| (a score
# near 0 may be a difference of large terms, so the score is no scale).
SCORE_REL = 1e-6


def _data(n=N, d=D_IN, nq=B, seed=SEED):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, d)).astype(np.float32)
    base = centers[rng.integers(0, 12, n)] + 0.5 * rng.standard_normal((n, d)).astype(np.float32)
    base *= np.exp(0.3 * rng.standard_normal((n, 1))).astype(np.float32)
    queries = centers[rng.integers(0, 12, nq)] + rng.standard_normal((nq, d)).astype(np.float32)
    return base.astype(np.float32), (queries + 0.7).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def qb(data):
    return RabitQuantizer(D_IN, seed=SEED, metric="ip").fit_encode(data[0])


@pytest.fixture(scope="module")
def enc(data):
    return reference_ip.encode(data[0], SEED)


def _index(qb, device="cpu"):
    empty = types.SimpleNamespace(adjacency=np.full((qb.norms.shape[0], 4), -1, np.int32),
                                  medoid=0)
    return from_host(qb, empty, device=device)


@pytest.fixture(scope="module")
def index(qb):
    return _index(qb)


# ------------------------------------------------------------- the encoding


def test_deployment_is_one_chips_share_of_text2image():
    """text2image-1B's 10^9 x 200 by inner product over 512 chips, as the
    benchmark's configuration has it: the scan deployment's own config
    class, the metric beside it."""
    cfg = text2image.CONFIG
    assert type(cfg) is type(text2image.REDUCED) is veloann.VeloServeConfig
    assert (text2image.METRIC, cfg.dim, cfg.k, cfg.rerank, cfg.query_batch) == \
        ("ip", 200, 10, 64, 4096)
    assert cfg.corpus_size == 512 * 1953125 and padded_dim(cfg.dim, text2image.METRIC) == 224
    assert text2image.REDUCED.rerank == 32


def test_padded_encoding_shapes_and_rotation(qb):
    D = padded_dim(D_IN, "ip")
    assert D == 224 and padded_dim(D_IN, "l2") == D_IN and padded_dim(256, "ip") == 256
    assert (qb.metric, qb.in_dim, qb.dim) == ("ip", D_IN, D)
    assert qb.rotation.shape == (D, D) and qb.centroid.shape == (D,)
    assert not qb.centroid[D_IN:].any()
    rr = qb.rotation.astype(np.float64) @ qb.rotation.astype(np.float64).T
    np.testing.assert_allclose(rr, np.eye(D), atol=1e-5)
    assert qb.binary_codes.shape == (N, D // 8) and qb.ext_codes.shape == (N, D // 2)
    assert qb.cr.shape == (N,) and qb.cr.dtype == np.float32
    assert qb.resident_bytes() == (qb.binary_codes.nbytes + qb.norms.nbytes + qb.ip_bar.nbytes
                                   + qb.centroid.nbytes + qb.cr.nbytes)


def test_cr_is_float64_rounded_once(data, qb):
    base = data[0].astype(np.float64)
    c = qb.centroid[:D_IN].astype(np.float64)
    exact = (base - c) @ c
    gap = np.abs(qb.cr.astype(np.float64) - exact)
    assert np.all(gap <= np.spacing(np.abs(qb.cr)).astype(np.float64) * 0.5 + 1e-300)
    # and |o - c| is the padded residual's norm: padding changes no norm
    np.testing.assert_allclose(qb.norms, np.linalg.norm(base - c, axis=1), rtol=1e-5)


def test_encoding_is_the_references_bit_for_bit(qb, enc):
    from repro_torch.core.quant import pack_bits, pack_nibbles

    assert np.array_equal(qb.centroid, enc.centroid) and np.array_equal(qb.rotation, enc.rotation)
    assert np.array_equal(qb.binary_codes, pack_bits(enc.signs))
    assert np.array_equal(qb.ext_codes, pack_nibbles(enc.codes))
    for name in ("norms", "ip_bar", "cr"):
        assert getattr(qb, name).tobytes() == getattr(enc, name).tobytes(), name
    assert qb.ext_lo.tobytes() == enc.lo.tobytes() and qb.ext_step.tobytes() == enc.step.tobytes()


@pytest.mark.parametrize("d", [128, 200, 24])
def test_l2_encoding_is_unchanged(d):
    """The default metric pads nothing and stores no cr: the JAX package's
    codes bit for bit at every d."""
    base = np.random.default_rng(d).standard_normal((400, d)).astype(np.float32)
    got = RabitQuantizer(d, seed=3).fit_encode(base)
    want = ref_quant.RabitQuantizer(d, seed=3).fit_encode(base)
    for f in ("centroid", "rotation", "binary_codes", "norms", "ip_bar", "ext_codes", "ext_lo",
              "ext_step"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert (got.metric, got.in_dim, got.dim, got.cr) == ("l2", d, d, None)
    assert got.resident_bytes() == want.resident_bytes()


def test_unknown_metric_is_refused():
    with pytest.raises(ValueError, match="metric"):
        RabitQuantizer(8, metric="cosine")


# ---------------------------------------------------------- the device index


def test_index_carries_metric_width_and_cr(qb, index):
    n = index.n
    assert (index.metric, index.in_dim, index.dim) == ("ip", D_IN, 224)
    assert torch.equal(index.cr[:n], torch.from_numpy(qb.cr))
    assert float(index.cr[n]) == -np.inf
    spec = synthetic_specs(1000, D_IN, 8, metric="ip")
    assert (spec.metric, spec.in_dim, spec.dim) == ("ip", D_IN, 224)
    assert spec.cr.shape == (1001,) and spec.binary_codes.shape == (1001, 28)
    l2 = synthetic_specs(1000, 128, 8)
    assert (l2.metric, l2.in_dim, l2.dim, l2.cr) == ("l2", 128, 128, None)


def test_sentinel_ranks_last(index, data):
    """-(cr + ...) with cr -inf: the sentinel's stage-1 rank and refined
    score are +inf."""
    n = index.n
    qr, qnorm, qunit, qc = bs._prepare_queries(index, torch.from_numpy(data[1]))
    rows = torch.tensor([0, n])
    g = ss.binary_ip_ref(qunit.to(torch.bfloat16), index.binary_codes[rows])
    est = sel_ref.estimate_ip(g, qnorm, index.norms[rows], index.ip_bar[rows], index.cr[rows],
                              index.dim)
    assert torch.isinf(est[:, 1]).all() and (est[:, 1] > 0).all()
    assert torch.isfinite(est[:, 0]).all()
    score = bs._refine(index, rows.expand(len(qr), 2), qr, qc)
    assert (score[:, 1] == np.inf).all() and torch.isfinite(score[:, 0]).all()


def test_queries_are_padded_and_checked(index, data):
    q = torch.from_numpy(data[1])
    qr, qnorm, qunit, qc = bs._prepare_queries(index, q)
    assert qr.shape == (B, 224) and qc.shape == (B, 1)
    np.testing.assert_allclose(qc[:, 0].numpy(), data[1].astype(np.float64)
                               @ index.centroid[:D_IN].numpy().astype(np.float64), rtol=1e-5)
    with pytest.raises(ValueError, match="width"):
        bs._prepare_queries(index, torch.zeros(2, 224))


def test_batch_search_refuses_inner_product(index, data):
    with pytest.raises(ValueError, match="inner product"):
        bs.batch_search(index, torch.from_numpy(data[1]), L=16, k=5, max_steps=4)


# ------------------------------------------------------ against the reference


@pytest.mark.parametrize("rerank", [32, 64])
@pytest.mark.parametrize("chunk", [500, 512, 4096])
def test_scan_search_ip_matches_reference(index, enc, data, chunk, rerank):
    q = torch.from_numpy(data[1])
    want_ids, want_score = reference_ip.scan(enc, data[1], 10, rerank)
    ids, score = ss.scan_search(index, q, k=10, rerank=rerank, chunk=chunk)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    qr, qc = reference_ip.prepare(enc, data[1])
    size = (np.abs(qc)[:, None] + np.linalg.norm(qr, axis=1)[:, None] * enc.norms[want_ids]
            + np.abs(enc.cr[want_ids]))
    assert np.all(np.abs(score.numpy() - want_score) <= SCORE_REL * size)
    assert ids.dtype == torch.int64 and score.dtype == torch.float32
    assert bool((score[:, 1:] >= score[:, :-1]).all())
    ids2, score2 = ss.scan_search(index, q, k=10, rerank=rerank, chunk=chunk, use_kernel=False)
    assert torch.equal(ids2, ids) and torch.equal(score2, score)


@pytest.mark.parametrize("lo,hi", [(0, 3000), (512, 1024), (2560, 3000)])
def test_stage1_ranks_are_the_references_bit_for_bit(index, enc, data, lo, hi):
    want = reference_ip.stage1(enc, data[1])[:, lo:hi]
    _, qnorm, qunit, _ = bs._prepare_queries(index, torch.from_numpy(data[1]))
    got = ss.stage1_block(qunit, qnorm, index.binary_codes[lo:hi], index.norms[lo:hi],
                          index.ip_bar[lo:hi], cr_blk=index.cr[lo:hi])
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_scan_select_plain_takes_cr(index, data):
    """``scan_select``'s plain version with ``cr`` merges inner product's
    ranks, and without it squared L2's: the two differ."""
    _, qnorm, qunit, _ = bs._prepare_queries(index, torch.from_numpy(data[1]))
    g = ss.binary_ip_ref(qunit.to(torch.bfloat16), index.binary_codes[:600])
    args = (g, qnorm, index.norms[:600], index.ip_bar[:600], index.dim, 32)
    ip = sel_ref.scan_select_ref(*args, cr=index.cr[:600])
    want = sel_ref.smallest(sel_ref.estimate_ip(g, qnorm, index.norms[:600], index.ip_bar[:600],
                                                index.cr[:600], index.dim), 32)
    assert torch.equal(ip[1], want[1]) and torch.equal(ip[0].view(torch.int16),
                                                       want[0].view(torch.int16))
    assert not torch.equal(sel_ref.scan_select_ref(*args)[1], ip[1])


def test_scan_search_ip_recall_against_exact(index, data):
    """The estimate steers: with 64 candidates most of the exact top-10 by
    inner product is found."""
    ids, _ = ss.scan_search(index, torch.from_numpy(data[1]), k=10, rerank=64)
    gt = reference_ip.exact_topk(*data, 10)
    hits = sum(len(set(a.tolist()) & set(g.tolist())) for a, g in zip(ids.numpy(), gt))
    assert hits / gt.size > 0.8


def test_scan_spans_are_recorded(index, data):
    tracing.start()
    try:
        ss.scan_search(index, torch.from_numpy(data[1]), k=10, rerank=32, chunk=512)
    finally:
        rec = tracing.stop()
    assert {"scan.prepare", "scan.stage1", "scan.rerank"} <= set(rec.totals)
    assert all(rec.totals[s][0] == 1 for s in ("scan.prepare", "scan.stage1", "scan.rerank"))


def test_l2_scan_unchanged_by_the_metric_paths():
    """A squared-L2 index still reads metric l2 with no cr, and its scan
    runs squared L2's estimator (a different answer from the same codes
    scored by inner product)."""
    base, queries = _data(n=900, d=64, nq=6, seed=3)
    l2 = _index(RabitQuantizer(64, seed=3).fit_encode(base))
    assert (l2.metric, l2.in_dim, l2.cr) == ("l2", 64, None)
    ids, d2 = ss.scan_search(l2, torch.from_numpy(queries), k=10, rerank=32, chunk=256)
    assert bool((d2 >= 0).all())


def test_tables_width_names_the_instantiation():
    """Inner product's query table is one bf16 qn a query, squared L2's the
    pair qn**2, 2 qn: the wrapper launches the instantiation that the width
    names, so one metric's tables never reach the other's kernel."""
    gen = torch.Generator().manual_seed(4)
    qnorm = torch.rand(5, 1, generator=gen) + 0.5
    norms = torch.rand(7, generator=gen) + 0.25
    ipb = torch.rand(7, generator=gen) * 0.9 + 0.05
    cr = torch.randn(7, generator=gen)
    l2 = sel_kernel.tables(qnorm, norms, ipb)
    ip = sel_kernel.tables(qnorm, norms, ipb, cr)
    assert l2[0].shape == (5, 2) and ip[0].shape == (5, 1) and ip[0].is_contiguous()
    assert torch.equal(ip[0][:, 0], qnorm[:, 0].to(torch.bfloat16))
    assert torch.equal(ip[1][:, 0], l2[1][:, 0]) and torch.equal(ip[2], l2[2])
    lo16 = 0xFFFF
    assert torch.equal(ip[1][:, 1] & lo16, l2[1][:, 1] & lo16)  # nr, the pair's low half
    assert torch.equal((ip[1][:, 1] >> 16) & lo16,
                       cr.to(torch.bfloat16).view(torch.int16).to(torch.int32) & lo16)


def test_reference_base_may_leave_out_only_the_inner_product_fields():
    """The JAX package's squared-L2 base lacks metric, in_dim and cr, and
    passes; without any other field the refusal names it."""
    base, _ = _data(n=300, d=64, nq=1, seed=5)
    ref = ref_quant.RabitQuantizer(64, seed=5).fit_encode(base)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    assert not {"metric", "in_dim", "cr"} & set(fields)
    with pytest.raises(ValueError, match="^graph: missing"):  # the base passed
        convert.index_from_reference(fields, {})
    del fields["ext_bits"]
    with pytest.raises(ValueError, match=r"^qb: missing fields \['ext_bits'\]"):
        convert.index_from_reference(fields, {})


# ----------------------------------------------------------- on a card only


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_index(cuda):
    """2 x 32 768 rows and a tail of 19 813 at d 200: every chunk at least
    TENSOR_CORE_MIN_ROWS, as the benchmark's cell has them."""
    base, queries = _data(n=2 * 32768 + 19813, nq=64, seed=11)
    qb = RabitQuantizer(D_IN, seed=11, metric="ip").fit_encode(base)
    return _index(qb, device=cuda), torch.from_numpy(queries)


def _same_carry(got, want, where):
    assert torch.equal(got[1], want[1]), f"ids differ {where}"
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16)), \
        f"values differ {where}"


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("nq", [8, 64, 4096])
def test_ip_scan_select_kernel_matches_plain(card_index, cuda, nq, C):
    """Every chunk of the scan, the tail included, from the first carry:
    the kernel's carry is the plain chain's bit for bit."""
    index, queries = card_index
    q = queries[torch.arange(nq) % len(queries)].to(cuda)
    q = q + 0.01 * torch.arange(nq, device=cuda)[:, None] / nq
    _, qnorm, qunit, _ = bs._prepare_queries(index, q)
    qb16 = qunit.to(torch.bfloat16)
    n, d, L = index.n, index.dim, 32768
    qtab, rtab, ipt = sel_kernel.tables(qnorm, index.norms[:n], index.ip_bar[:n], index.cr[:n])
    carry = (torch.full((nq, C), 3e38, dtype=torch.bfloat16, device=cuda),
             torch.zeros((nq, C), dtype=torch.int64, device=cuda))
    n0, i0 = sel_kernel.launches, sel_kernel.ip_launches
    for lo in range(0, n, L):
        hi = min(lo + L, n)
        g = ss.binary_ip(qb16, index.binary_codes[lo:hi])
        got = sel_kernel.scan_select_cuda(g, qtab, rtab[lo:hi], ipt[lo:hi], d, C, lo, carry)
        want = sel_ref.scan_select_ref(g, qnorm, index.norms[lo:hi], index.ip_bar[lo:hi], d, C,
                                       lo, carry, cr=index.cr[lo:hi])
        _same_carry(got, want, f"after the chunk at {lo} (L {hi - lo})")
        carry = want
    assert sel_kernel.launches - n0 == sel_kernel.ip_launches - i0 == 3
    got = sel_kernel.scan_select_cuda(g, qtab, rtab[lo:hi], ipt[lo:hi], d, C)
    _same_carry(got, sel_ref.scan_select_ref(g, qnorm, index.norms[lo:hi], index.ip_bar[lo:hi],
                                             d, C, cr=index.cr[lo:hi]), "without a carry")


@pytest.mark.cuda
def test_ip_scan_search_card_on_tensor_cores(card_index, cuda):
    """scan_search over the inner-product index on the card: one binary_ip
    launch a chunk, each on the tensor cores at D 224, one inner-product
    scan_select a chunk, and the plain chain's ids and scores."""
    index, queries = card_index
    q = queries.to(cuda)
    b0, t0 = bip_kernel.launches, bip_kernel.tensor_core_launches
    s0, i0 = sel_kernel.launches, sel_kernel.ip_launches
    ids, score = ss.scan_search(index, q, k=10, rerank=64)
    assert bip_kernel.launches - b0 == bip_kernel.tensor_core_launches - t0 == 3
    assert sel_kernel.launches - s0 == sel_kernel.ip_launches - i0 == 3
    want_ids, want_score = ss.scan_search(index, q, k=10, rerank=64, use_kernel=False)
    assert torch.equal(ids, want_ids) and torch.equal(score, want_score)
    assert bip_kernel.tensor_core_path(len(q), 19813, 224, index.binary_codes[65536:].data_ptr())
