"""examples/quickstart_torch.py against examples/quickstart.py on the CPU.

Both examples run their own steps on one Vamana graph, built once by the
reference over the examples' 5 000 x 64 corpus (the port's
``build_vamana`` equals the reference's array for array,
tests/test_torch_index.py) and carried into the port with ``convert``;
each example's call to ``build_vamana`` must pass the reference's
arguments.  Held: every printed line but the build's seconds, and the
whole ``evaluate`` report (recall, simulated QPS and latency, I/O per
query, hit rate, dispatch counts) but the backend's name.
"""

import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import pytest
import torch

from repro.core import dataset as ref_dataset
from repro.core import vamana as ref_vamana
from repro.core.quant import RabitQuantizer as RefQuantizer
from repro_torch import convert

ROOT = Path(__file__).resolve().parents[1]
GRAPH_ARGS = dict(R=24, L=48, seed=0)


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, graph, argv) -> dict:
    """``mod.main(argv)`` with ``build_vamana`` answered by ``graph``: its
    printed lines, ``evaluate``'s reports and ``build_vamana``'s arguments."""
    calls, reports = [], []
    evaluate = mod.baselines.evaluate

    def build(base, **kw):
        calls.append((base.shape, kw))
        return graph

    def spy(system, ds, *a, **kw):
        reports.append(evaluate(system, ds, *a, **kw))
        return reports[-1]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(mod.vamana, "build_vamana", build)
        mp.setattr(mod.baselines, "evaluate", spy)
        mod.main(*argv)
    return dict(lines=out.getvalue().splitlines(), reports=reports, calls=calls)


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def reference_graph(n, d, n_queries, seed, graph_args):
    """The examples' corpus, the reference's graph over it and the graph
    carried into the port."""
    ds = ref_dataset.make_dataset(n=n, d=d, n_queries=n_queries, k=10, seed=seed)
    graph = ref_vamana.build_vamana(ds.base, **graph_args)
    qb = RefQuantizer(ds.dim, seed=seed).fit_encode(ds.base)
    return graph, convert.index_from_reference(fields(qb), fields(graph))[1]


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(2)
    ref_graph, port_graph = reference_graph(5000, 64, 200, 0, GRAPH_ARGS)
    return (run_example(load("quickstart"), ref_graph, ()),
            run_example(load("quickstart_torch"), port_graph, (["--device", "cpu"],)))


def test_both_build_the_references_graph(runs):
    ref, port = runs
    assert ref["calls"] == port["calls"] == [((5000, 64), GRAPH_ARGS)]


def test_printed_lines_equal_the_references(runs):
    ref, port = runs
    strip = lambda line: line.rsplit(" (", 1)[0]  # noqa: E731 — the build's seconds
    assert [strip(ref["lines"][0])] + ref["lines"][1:] == \
        [strip(port["lines"][0])] + port["lines"][1:]
    assert port["lines"][-1] == "OK"


def test_evaluate_reports_equal_the_references(runs):
    ref, port = runs
    (want,), (got,) = ref["reports"], port["reports"]
    assert want.pop("distance_backend") == "batch" and got.pop("distance_backend") == "torch"
    assert got == want


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load("quickstart_torch").main([])
