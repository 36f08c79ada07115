"""The port's index build and index-image conversion against the JAX package.

Same seeds must give the same dataset, the same Vamana adjacency, medoid and
affinity, and byte-identical page images for the VeloANN (slotted, affinity
co-placed) and DiskANN/Starling (fixed-record) layouts.  ``convert.
index_from_reference`` must carry the reference's build artifacts across bit
for bit.  No tolerance anywhere: these are the same NumPy algorithms.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import codec as ref_codec
from repro.core import dataset as ref_dataset
from repro.core import store as ref_store
from repro_torch import convert
from repro_torch.core import codec as port_codec
from repro_torch.core import dataset as port_dataset
from repro_torch.core import distance as distance_mod
from repro_torch.core import store as port_store
from repro_torch.core import vamana as port_vamana


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    old = distance_mod.default_device()
    distance_mod.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    distance_mod.set_default_device(old)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def carried(small_qb, small_graph):
    return convert.index_from_reference(_fields(small_qb), _fields(small_graph))


def test_dataset_is_identical():
    kw = dict(n=700, d=24, n_queries=20, k=5, seed=3)
    got, want = port_dataset.make_dataset(**kw), ref_dataset.make_dataset(**kw)
    for f in ("base", "queries", "groundtruth"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_build_vamana_is_identical(small_ds, small_graph):
    got = port_vamana.build_vamana(small_ds.base, R=20, L=40, batch_size=256, seed=0)
    assert np.array_equal(got.adjacency, small_graph.adjacency)
    assert np.array_equal(got.degrees, small_graph.degrees)
    assert (got.medoid, got.R, got.tau) == (small_graph.medoid, small_graph.R,
                                            small_graph.tau)
    assert got.affinity == small_graph.affinity


@pytest.mark.parametrize("codec", ["pef", "delta"])
def test_velo_page_images_are_identical(small_ds, small_graph, small_qb, carried, codec):
    qb, graph = carried
    want = ref_store.VeloIndex(small_ds.base, small_graph, small_qb, adj_codec=codec)
    got = port_store.VeloIndex(small_ds.base, graph, qb, adj_codec=codec)
    assert got.store.pages == want.store.pages
    assert np.array_equal(got.layout.vid_to_page, want.layout.vid_to_page)
    assert got.disk_bytes() == want.disk_bytes()
    assert got.resident_bytes() == want.resident_bytes()
    for vid in (0, 17, 1499):
        page = got.store.read_page(got.page_of(vid))
        rec = got.decode_record(vid, page)
        assert np.array_equal(rec.adjacency, np.sort(graph.neighbors(vid)))
        assert rec.ext_payload == qb.record_payload(vid)


@pytest.mark.parametrize("shuffle", [False, True])
def test_fixed_page_images_are_identical(small_ds, small_graph, small_qb, carried, shuffle):
    qb, graph = carried
    want = ref_store.FixedIndex(small_ds.base, small_graph, small_qb, shuffle=shuffle)
    got = port_store.FixedIndex(small_ds.base, graph, qb, shuffle=shuffle)
    assert got.store.pages == want.store.pages
    assert np.array_equal(got.vid_to_page, want.vid_to_page)
    assert got.page_members == want.page_members


def test_adjacency_codecs_are_identical():
    ids = np.unique(np.random.default_rng(5).integers(0, 100_000, 60)).astype(np.uint32)
    for name in ("pef", "delta"):
        enc = port_codec.encode_adjacency(ids, name)
        assert enc == ref_codec.encode_adjacency(ids, name)
        assert np.array_equal(port_codec.decode_adjacency(enc, name), ids)


def test_index_from_reference_round_trips(small_qb, small_graph, carried):
    qb, graph = carried
    for name, want in _fields(small_qb).items():
        got = getattr(qb, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
            assert not np.shares_memory(got, want), name
        else:
            assert got == want, name
    for name, want in _fields(small_graph).items():
        got = getattr(graph, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
        else:
            assert got == want, name


def test_index_from_reference_rejects_malformed(small_qb, small_graph):
    qb, graph = _fields(small_qb), _fields(small_graph)
    with pytest.raises(ValueError, match="missing"):
        convert.index_from_reference({k: v for k, v in qb.items() if k != "norms"}, graph)
    with pytest.raises(ValueError, match="float32"):
        convert.index_from_reference({**qb, "norms": qb["norms"].astype(np.float64)}, graph)
    with pytest.raises(ValueError, match="adjacency"):
        convert.index_from_reference(qb, {**graph, "adjacency": graph["adjacency"][:10]})
