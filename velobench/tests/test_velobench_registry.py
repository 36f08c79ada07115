"""The harness finds every piece by name, BENCHMARK.json keeps to the
benchmark's contract, each cell reports one bound class, and a new cell,
metric or driver is new files only."""

import hashlib
import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from velobench import harness, registry  # noqa: E402

BENCH = registry.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT_OK = re.compile(r"[^\n\t]{1,200}")
# the class each cell was measured under: a cell never moves to another
PINNED = {"sift1m-velo.zipf": "engine", "veloann-scan.b4096": "scan",
          "veloann-scan.b8": "smallbatch"}


def bound_class(bench: dict, cell_name: str) -> str:
    """The suffix X that the cell's end-to-end metrics share: exactly
    ``{qps.X, p95_ms.X, recall_at_10.X, setup_s}`` as the ``workloads``
    lists of ``bench`` give them, and every per-layer metric of the cell
    moving ``qps.X``.  Raises ``ValueError`` where the lists make no such
    class."""
    names = {m["name"] for m in registry.metrics_for(bench, cell_name, False)}
    classes = {n.split(".", 1)[1] for n in names if n.startswith("qps.")}
    if len(classes) != 1:
        raise ValueError(f"{cell_name} reports qps of {len(classes)} classes: {sorted(classes)}")
    x = classes.pop()
    want = {f"qps.{x}", f"p95_ms.{x}", f"recall_at_10.{x}", "setup_s"}
    if names != want:
        raise ValueError(f"{cell_name} reports {sorted(names)}, not class {x}'s {sorted(want)}")
    traced = registry.metrics_for(bench, cell_name, True)
    moves = {m["moves"] for m in traced}
    if moves != {f"qps.{x}"}:
        raise ValueError(f"{cell_name}'s per-layer metrics move {sorted(moves)}, not qps.{x}")
    return x


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "velobench/run.py"]
    assert BENCH["paths"] == ["velobench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells must fit the driver's 43 200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"])
    assert TEXT_OK.fullmatch(entry["source"]) and TEXT_OK.fullmatch(entry["why"])
    assert entry["file"] == f"velobench/configs/{entry['name']}.json"
    cfg = registry.config(entry["name"])
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert all(NAME.fullmatch(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_entry_finds_its_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    cell = registry.cell(entry["name"])
    assert cell["config"] == entry["config"] and cell["chips"] == entry["chips"] == 1
    assert cell["traffic"]["name"] == entry["traffic"] and cell["why"] == entry["why"]
    assert TEXT_OK.fullmatch(entry["why"])
    assert hasattr(registry.driver(cell["driver"]), "Driver")
    assert registry.config(cell["config"])["name"] == cell["config"]
    assert cell["limits"]["bad_answers"] == 0
    part = bound_class(BENCH, entry["name"])
    assert PINNED.get(entry["name"], part) == part


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entry_finds_its_reader(entry):
    per_layer = entry in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(entry) - {"workloads"} == keys
    assert NAME.fullmatch(entry["name"]) and UNIT.fullmatch(entry["unit"])
    mod = registry.metric(entry["name"])
    assert mod.UNIT == entry["unit"] and mod.BETTER == entry["better"]
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if per_layer:
        moved = [m for m in BENCH["end_to_end"] if m["name"] == entry["moves"]]
        assert moved and set(entry["workloads"]) <= set(moved[0]["workloads"])
        assert TEXT_OK.fullmatch(entry["layer"])
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


def test_names_cannot_leave_their_folder():
    for bad in ("", "../x", "a/b", ".hidden", "x" * 65, "a b"):
        with pytest.raises(ValueError):
            registry.check_name(bad)
    with pytest.raises(FileNotFoundError):
        registry.metric("no.such.metric")


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts
            and "cache" not in p.parts}


def _copy(tmp_path: Path) -> tuple[Path, dict]:
    """A copy of the benchmark's folder and of BENCHMARK.json under
    ``tmp_path``: (the folder, its digests)."""
    here = tmp_path / "velobench"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return here, _digests(here)


def _join(bench: dict, cell_name: str, part: str) -> None:
    """List ``cell_name`` under class ``part``'s three end-to-end metrics."""
    for m in bench["end_to_end"]:
        if m["name"] in (f"qps.{part}", f"p95_ms.{part}", f"recall_at_10.{part}"):
            m["workloads"].append(cell_name)


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    here, before = _copy(tmp_path)

    cell = json.loads((here / "workloads" / "veloann-scan.b4096.json").read_text())
    cell["traffic"].update(name="b64", batch=64)
    cell["why"] = "scan_search calls of 64 queries: between the interactive and the batched scan"
    (here / "workloads" / "veloann-scan.b64.json").write_text(json.dumps(cell))
    (here / "metrics" / "scan.calls.py").write_text(
        'UNIT, BETTER = "calls", "higher"\n\n\ndef read(run):\n    return run.calls\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "veloann-scan.b64", "config": "veloann-scan",
                               "traffic": "b64", "chips": 1, "why": cell["why"]})
    _join(bench, "veloann-scan.b64", "scan")
    bench["per_layer"].append({"name": "scan.calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "velo/scan_search",
                               "moves": "qps.scan", "workloads": ["veloann-scan.b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"workloads/veloann-scan.b64.json", "metrics/scan.calls.py"}
    found = registry.cell("veloann-scan.b64", here)
    assert found["traffic"]["batch"] == 64
    assert registry.config(found["config"], here)["name"] == "veloann-scan"
    assert hasattr(registry.driver(found["driver"], here), "Driver")
    b = registry.benchmark(tmp_path)
    assert bound_class(b, "veloann-scan.b64") == "scan"
    traced = [m["name"] for m in registry.metrics_for(b, "veloann-scan.b64", True)]
    assert "scan.calls" in traced and "device.idle_share.engine" not in traced
    run = type("Run", (), {"calls": 7})()
    assert registry.metric("scan.calls", here).read(run) == 7


def test_pinned_cells_keep_their_class():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(PINNED) <= cells
    assert {name: bound_class(BENCH, name) for name in PINNED} == PINNED


def test_a_driver_of_its_own_joins_a_class_with_new_files_only(tmp_path, monkeypatch):
    """A deployment with a driver, a configuration and a cell of its own
    reports the ``.scan`` class it is listed under, and runs end to end,
    with nothing of the benchmark edited but BENCHMARK.json's lists."""
    here, before = _copy(tmp_path)
    shutil.copy(here / "drivers" / "scan.py", here / "drivers" / "scan_own.py")
    cfg = json.loads((here / "configs" / "veloann-scan.json").read_text())
    cfg["name"] = "own-scan"
    (here / "configs" / "own-scan.json").write_text(json.dumps(cfg))
    cell = json.loads((here / "workloads" / "veloann-scan.b4096.json").read_text())
    cell.update(config="own-scan", driver="scan_own")
    cell["why"] = "a deployment of its own, driven by its own file, under the scan's bounds"
    (here / "workloads" / "own-scan.b4096.json").write_text(json.dumps(cell))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "own-scan", "source": cfg["source"],
                             "file": "velobench/configs/own-scan.json",
                             "reduced": cfg["reduced"], "why": cell["why"]})
    bench["workloads"].append({"name": "own-scan.b4096", "config": "own-scan",
                               "traffic": "b4096", "chips": 1, "why": cell["why"]})
    _join(bench, "own-scan.b4096", "scan")
    for m in bench["per_layer"]:
        if m["moves"] == "qps.scan":
            m["workloads"].append("own-scan.b4096")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"drivers/scan_own.py", "configs/own-scan.json",
                                        "workloads/own-scan.b4096.json"}
    b = registry.benchmark(tmp_path)
    assert bound_class(b, "own-scan.b4096") == "scan"
    assert {name: bound_class(b, name) for name in PINNED} == PINNED

    monkeypatch.setattr(registry, "HERE", here)
    found = registry.cell("own-scan.b4096")
    assert found["driver"] == "scan_own" and registry.config(found["config"])["name"] == "own-scan"
    cfg.update(n=3000, d=32, chunk=1024)
    found["traffic"].update(pool=200, batch=32, sample=40)
    result, _ = harness.run_cell("own-scan.b4096", 2**31 + 77, 0.3, False, "cpu",
                                 time.perf_counter(), bench=b, cell=found, cfg=cfg,
                                 log=lambda msg: None)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"qps.scan", "p95_ms.scan", "recall_at_10.scan", "setup_s"}


def _moved(bench: dict, metric: str, cell_name: str, to: str | None) -> dict:
    """A copy of ``bench`` with ``cell_name`` taken off ``metric``'s list
    and put on ``to``'s (or on none)."""
    bench = json.loads(json.dumps(bench))
    for m in bench["end_to_end"]:
        if m["name"] == metric:
            m["workloads"].remove(cell_name)
        if m["name"] == to:
            m["workloads"].append(cell_name)
    return bench


@pytest.mark.parametrize("metric,to", [
    ("recall_at_10.scan", "recall_at_10.engine"),
    ("p95_ms.scan", "p95_ms.smallbatch"),
    ("qps.scan", "qps.engine"),
    ("recall_at_10.scan", None),
], ids=lambda v: str(v))
def test_a_cell_that_mixes_two_classes_fails(metric, to):
    assert bound_class(BENCH, "veloann-scan.b4096") == "scan"
    with pytest.raises(ValueError):
        bound_class(_moved(BENCH, metric, "veloann-scan.b4096", to), "veloann-scan.b4096")


def test_a_cell_on_two_classes_fails():
    bench = json.loads(json.dumps(BENCH))
    _join(bench, "veloann-scan.b8", "scan")
    with pytest.raises(ValueError, match="2 classes"):
        bound_class(bench, "veloann-scan.b8")


@pytest.mark.parametrize("cell_name,other", [
    ("veloann-scan.b4096", "qps.engine"), ("veloann-scan.b8", "qps.scan"),
    ("sift1m-velo.zipf", "qps.smallbatch")])
def test_a_per_layer_metric_that_moves_another_class_fails(cell_name, other):
    bench = json.loads(json.dumps(BENCH))
    traced = [m for m in bench["per_layer"] if cell_name in m["workloads"]]
    traced[0]["moves"] = other
    with pytest.raises(ValueError, match="per-layer"):
        bound_class(bench, cell_name)


def test_b8_is_found_and_reports_the_smallbatch_class():
    cell = registry.cell("veloann-scan.b8")
    assert cell["driver"] == "scan" and cell["config"] == "veloann-scan" and cell["chips"] == 1
    assert cell["traffic"] == {"name": "b8", "pool": 10000, "query_skew": 1.2, "batch": 8,
                               "sample": 1024}
    assert cell["limits"] == registry.cell("veloann-scan.b4096")["limits"]
    assert bound_class(BENCH, "veloann-scan.b8") == "smallbatch"
    untraced = {m["name"] for m in registry.metrics_for(BENCH, "veloann-scan.b8", False)}
    assert untraced == {"qps.smallbatch", "p95_ms.smallbatch", "recall_at_10.smallbatch",
                        "setup_s"}
    traced = {m["name"] for m in registry.metrics_for(BENCH, "veloann-scan.b8", True)}
    assert traced == {"scan.launches_per_call.smallbatch", "device.idle_share.smallbatch"}
    for name in untraced | traced:  # each read by the quantity's own reader
        assert registry.metric(name).__file__ == str(
            registry.HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py")
