"""Both drivers end to end on the CPU at small sizes: set-up, warm-up, the
window, the reference and the metrics, with ``correct`` true; the index
cache serves a seed's second run."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import velobench_tiny as tiny  # noqa: E402

from velobench import data, index_cache, registry  # noqa: E402


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("velobench_cache")


@pytest.mark.parametrize("name", [tiny.ENGINE, tiny.SCAN])
def test_driver_end_to_end(name, cache_dir):
    result, lines = tiny.run(name, cache_dir)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks" and lines[-1] == "correct: True"
    metrics = result["metrics"]
    want = {m["name"] for m in registry.metrics_for(registry.benchmark(), name, False)}
    assert set(metrics) == want
    part = registry.cell(name)["driver"]
    assert metrics[f"qps.{part}"]["value"] > 0
    assert 0 < metrics[f"recall_at_10.{part}"]["value"] <= 1
    assert metrics[f"p95_ms.{part}"]["unit"] == "ms" and metrics["setup_s"]["value"] > 0
    assert result["device"]["platform"] == "cpu"
    json.dumps(result)  # one JSON line


def test_engine_cache_serves_the_second_run(cache_dir):
    logs = []
    c, cfg = tiny.cell(tiny.ENGINE)
    drv = registry.driver(c["driver"])
    base, _ = data.inputs(cfg, c["traffic"], 77)
    g1 = drv.open_graph(cfg, base, 77, logs.append, cache_dir)
    g2 = drv.open_graph(cfg, base, 77, logs.append, cache_dir)
    assert len(logs) == 1 and "built" in logs[0]
    assert (g1.adjacency == g2.adjacency).all() and g1.medoid == g2.medoid
    assert g1.affinity == g2.affinity and g1.tau == g2.tau
    entries = list(Path(cache_dir).glob("sift1m-velo-77-*.npz"))
    assert len(entries) == 1 and entries[0].stat().st_size < 4 * 2**20
    other, _ = data.generate(cfg["n"], cfg["d"], 4, 78)
    params = drv.build_params(cfg)
    assert index_cache.path("sift1m-velo", 77, base, params, cache_dir) == entries[0]
    assert index_cache.path("sift1m-velo", 77, other, params, cache_dir) != entries[0]


def test_engine_cache_key_follows_the_build_source(monkeypatch):
    base = np.zeros((4, 2), np.float32)
    k1 = index_cache.key(base, {})
    monkeypatch.setattr(index_cache, "build_source", lambda: b"another build")
    assert index_cache.key(base, {}) != k1


def test_the_seed_makes_the_data():
    # a configuration without a data_seed draws its rows from the seed
    c, cfg = tiny.cell(tiny.SCAN)
    cfg = {k: v for k, v in cfg.items() if k != "data_seed"}
    assert data.index_seed(cfg, 2**31 + 5) == 2**31 + 5
    a, qa = data.inputs(cfg, c["traffic"], 1)
    b, qb = data.inputs(cfg, c["traffic"], 2**31 + 5)
    assert a.shape == b.shape and qa.shape == qb.shape and not np.allclose(a, b)
    a2, qa2 = data.inputs(cfg, c["traffic"], 1)
    assert (a2 == a).all() and (qa2 == qa).all()
    # the engine and the scan each serve one index from their data_seed; the
    # seed orders the pool
    for name in (tiny.ENGINE, tiny.SCAN):
        c, cfg = tiny.cell(name)
        assert "data_seed" in cfg and data.index_seed(cfg, 1) == cfg["data_seed"]
        a, qa = data.inputs(cfg, c["traffic"], 1)
        b, qb = data.inputs(cfg, c["traffic"], 2**31 + 5)
        assert (a == b).all() and not (qa == qb).all()
        order = lambda q: np.lexsort(q.T[::-1])  # noqa: E731
        assert (qa[order(qa)] == qb[order(qb)]).all()
        a2, qa2 = data.inputs(cfg, c["traffic"], 1)
        assert (a2 == a).all() and (qa2 == qa).all()
