"""examples/serve_batch_torch.py against examples/serve_batch.py on the CPU.

As tests/test_torch_examples_quickstart.py holds the quickstart: one Vamana
graph over the examples' 10 000 x 64 corpus, built once by the reference;
every printed line but the build's seconds (the twin adds a closing
``OK``) and the four systems' whole ``evaluate`` reports, whose simulated
QPS gives the example's ``speedup > 2.0``, equal to the reference's.
"""

import pytest
import torch

from test_torch_examples_quickstart import load, reference_graph, run_example

GRAPH_ARGS = dict(R=24, L=48, seed=1)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(2)
    ref_graph, port_graph = reference_graph(10000, 64, 400, 1, GRAPH_ARGS)
    return (run_example(load("serve_batch"), ref_graph, ()),
            run_example(load("serve_batch_torch"), port_graph, (["--device", "cpu"],)))


def test_both_build_the_references_graph(runs):
    ref, port = runs
    assert ref["calls"] == port["calls"] == [((10000, 64), GRAPH_ARGS)]


def test_printed_lines_equal_the_references(runs):
    ref, port = runs
    strip = lambda line: line.split(" (", 1)[1]  # noqa: E731 — after the build's seconds
    assert [strip(ref["lines"][0])] + ref["lines"][1:] + ["OK"] == \
        [strip(port["lines"][0])] + port["lines"][1:]


def test_evaluate_reports_equal_the_references(runs):
    ref, port = runs
    assert len(ref["reports"]) == len(port["reports"]) == 4
    for want, got in zip(ref["reports"], port["reports"]):
        assert want.pop("distance_backend") == "batch"
        assert got.pop("distance_backend") == "torch"
        assert got == want


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load("serve_batch_torch").main([])
