"""The harness finds every piece by name, BENCHMARK.json keeps to the
benchmark's contract, and a new cell or metric is new files only."""

import hashlib
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from velobench import registry  # noqa: E402

BENCH = registry.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT_OK = re.compile(r"[^\n\t]{1,200}")


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
    names = {m["name"] for m in registry.metrics_for(BENCH, entry["name"], False)}
    part = cell["driver"]
    assert {f"qps.{part}", f"p95_ms.{part}", f"recall_at_10.{part}", "setup_s"} == names
    traced = registry.metrics_for(BENCH, entry["name"], True)
    assert traced and {m["moves"] for m in traced} == {f"qps.{part}"}


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


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    here = tmp_path / "velobench"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(here)

    cell = json.loads((here / "workloads" / "veloann-scan.b4096.json").read_text())
    cell["traffic"].update(name="b8", batch=8)
    cell["why"] = "scan_search calls of 8 queries: the dense work bypassed, launches set the pace"
    (here / "workloads" / "veloann-scan.b8.json").write_text(json.dumps(cell))
    (here / "metrics" / "scan.calls.py").write_text(
        'UNIT, BETTER = "calls", "higher"\n\n\ndef read(run):\n    return run.calls\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "veloann-scan.b8", "config": "veloann-scan",
                               "traffic": "b8", "chips": 1, "why": cell["why"]})
    bench["per_layer"].append({"name": "scan.calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "velo/scan_search",
                               "moves": "qps.scan", "workloads": ["veloann-scan.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"workloads/veloann-scan.b8.json", "metrics/scan.calls.py"}
    found = registry.cell("veloann-scan.b8", here)
    assert found["traffic"]["batch"] == 8
    assert registry.config(found["config"], here)["name"] == "veloann-scan"
    assert hasattr(registry.driver(found["driver"], here), "Driver")
    b = registry.benchmark(tmp_path)
    traced = [m["name"] for m in registry.metrics_for(b, "veloann-scan.b8", True)]
    assert "scan.calls" in traced and "device.idle_share.engine" not in traced
    run = type("Run", (), {"calls": 7})()
    assert registry.metric("scan.calls", here).read(run) == 7
