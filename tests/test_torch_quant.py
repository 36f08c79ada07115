"""The port's quantizer builds the JAX package's index image byte for byte.

``repro_torch.core.quant`` is the host-side NumPy build both packages share
a format with: the same base and seed must give identical codes, norms,
``ip_bar`` and extended-code arrays (same dtypes, same bytes), and the
NumPy estimators over them must return identical values.  No tolerance:
the arithmetic is the same NumPy code on the same inputs.
"""

import numpy as np
import pytest
import torch

from repro.core import quant as ref_quant
from repro_torch.core import distance as distance_mod
from repro_torch.core import quant as port_quant

QB_FIELDS = ("centroid", "rotation", "binary_codes", "norms", "ip_bar",
             "ext_codes", "ext_lo", "ext_step")


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    old = distance_mod.default_device()
    distance_mod.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    distance_mod.set_default_device(old)


def _assert_same_array(a, b, what):
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bytes differ"


@pytest.mark.parametrize("n,d,seed,ext_bits", [
    (500, 64, 0, 4), (300, 128, 3, 4), (257, 24, 7, 8), (64, 960, 1, 4),
])
def test_fit_encode_is_byte_identical(n, d, seed, ext_bits):
    base = np.random.default_rng(seed + 100).standard_normal((n, d)).astype(np.float32)
    want = ref_quant.RabitQuantizer(d, seed=seed, ext_bits=ext_bits).fit_encode(base)
    got = port_quant.RabitQuantizer(d, seed=seed, ext_bits=ext_bits).fit_encode(base)
    for f in QB_FIELDS:
        _assert_same_array(getattr(got, f), getattr(want, f), f)
    assert (got.dim, got.ext_bits) == (want.dim, want.ext_bits)
    assert got.resident_bytes() == want.resident_bytes()
    assert got.record_payload(5) == want.record_payload(5)


def test_bit_and_nibble_packing_layouts():
    """Little-endian bits within a byte; low nibble = even dimension."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (9, 40)).astype(np.uint8)
    nibs = rng.integers(0, 16, (9, 40)).astype(np.uint8)
    _assert_same_array(port_quant.pack_bits(bits), ref_quant.pack_bits(bits), "bits")
    _assert_same_array(port_quant.pack_nibbles(nibs), ref_quant.pack_nibbles(nibs), "nibs")
    packed = port_quant.pack_bits(bits)
    assert packed[0, 0] == sum(int(bits[0, j]) << j for j in range(8))
    _assert_same_array(port_quant.unpack_bits(packed, 40), bits, "unpack bits")
    pn = port_quant.pack_nibbles(nibs)
    assert pn[0, 0] == int(nibs[0, 0]) | (int(nibs[0, 1]) << 4)
    _assert_same_array(port_quant.unpack_nibbles(pn, 40), nibs, "unpack nibbles")


def test_query_and_estimators_are_identical(small_ds, small_qb):
    port_qb = port_quant.RabitQuantizer(small_ds.dim, seed=0).fit_encode(small_ds.base)
    ids = np.arange(0, small_qb.norms.shape[0], 7)
    for q in small_ds.queries[:3]:
        pq_ref = ref_quant.RabitQuantizer.prepare_query(small_qb, q)
        pq = port_quant.RabitQuantizer.prepare_query(port_qb, q)
        for f in ("qr", "qunit", "q_orig"):
            _assert_same_array(getattr(pq, f), getattr(pq_ref, f), f)
        assert pq.qnorm == pq_ref.qnorm
        _assert_same_array(
            port_quant.RabitQuantizer.estimate_dist2(port_qb, pq, ids),
            ref_quant.RabitQuantizer.estimate_dist2(small_qb, pq_ref, ids), "estimate")
        _assert_same_array(
            port_quant.RabitQuantizer.refine_dist2(port_qb, pq, ids),
            ref_quant.RabitQuantizer.refine_dist2(small_qb, pq_ref, ids), "refine")
        assert port_quant.RabitQuantizer.refine_dist2_from_payload(
            port_qb, pq, port_qb.record_payload(11)
        ) == ref_quant.RabitQuantizer.refine_dist2_from_payload(
            small_qb, pq_ref, small_qb.record_payload(11))


def test_resident_and_slot_views_gather_identically(small_qb):
    port_qb = port_quant.QuantizedBase(
        **{f: getattr(small_qb, f) for f in QB_FIELDS},
        dim=small_qb.dim, ext_bits=small_qb.ext_bits,
    )
    ids = np.asarray([3, 0, 1499, 3, 77])
    got = port_quant.ResidentView.from_qb(port_qb)
    want = ref_quant.ResidentView.from_qb(small_qb)
    for g, w in zip(got.gather_level1(ids) + got.gather_level2(ids),
                    want.gather_level1(ids) + want.gather_level2(ids)):
        _assert_same_array(g, w, "resident gather")
    assert got.nbytes() == want.nbytes()
    slot_view = port_quant.CacheSlotView(
        qb=port_qb, ext=port_qb.ext_codes[:10], lo=port_qb.ext_lo[:10],
        step=port_qb.ext_step[:10])
    for g, w in zip(slot_view.gather(np.asarray([9, 2])),
                    want.gather_level2(np.asarray([9, 2]))):
        _assert_same_array(g, w, "slot gather")
