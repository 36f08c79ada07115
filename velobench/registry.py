"""Finds the benchmark's pieces by name: cells, configurations, drivers,
metric readers, and the entries of ``BENCHMARK.json`` that name them.

A name is what the benchmark's contract allows (a letter, digit or ``_``,
then at most 63 letters, digits, ``_``, ``.`` or ``-``), so it can never
leave its folder."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path | None = None) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _json((root or REPO) / "BENCHMARK.json")


def cell(name: str, here: Path | None = None) -> dict:
    """``workloads/<name>.json``, with its own name added."""
    out = _json((here or HERE) / "workloads" / f"{check_name(name)}.json")
    out["name"] = name
    return out


def config(name: str, here: Path | None = None) -> dict:
    """``configs/<name>.json``."""
    out = _json((here or HERE) / "configs" / f"{check_name(name)}.json")
    if out.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {out.get('name')!r}")
    return out


def _module(kind: str, name: str, here: Path | None = None, file: str | None = None):
    path = (here or HERE) / kind / f"{check_name(file or name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"velobench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: Path | None = None):
    """``drivers/<name>.py``: a module with a ``Driver`` class."""
    return _module("drivers", name, here)


def metric(name: str, here: Path | None = None):
    """``metrics/<name>.py``: a module with ``UNIT``, ``BETTER`` and
    ``read(run) -> float | None``.  A quantity split by bound class
    (``qps.engine``, ``qps.scan``, ``qps.smallbatch``: one bound each) is
    read by the quantity's file (``metrics/qps.py``) unless the split name
    has its own.  A cell's class is the suffix X that its end-to-end
    metrics share, ``{qps.X, p95_ms.X, recall_at_10.X, setup_s}``, as
    ``BENCHMARK.json``'s ``workloads`` lists give them, whatever its
    driver's file is called; every per-layer metric of the cell moves
    ``qps.X``.  A deployment with a driver of its own joins a class by
    being listed under its metrics."""
    own = (here or HERE) / "metrics" / f"{check_name(name)}.py"
    if own.is_file() or "." not in name:
        return _module("metrics", name, here)
    return _module("metrics", name, here, file=name.rsplit(".", 1)[0])


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The entries of ``BENCHMARK.json`` that a run of ``cell_name`` reports:
    its end-to-end metrics untraced, its per-layer metrics traced.  An entry
    without ``workloads`` belongs to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell_name in m["workloads"]]
