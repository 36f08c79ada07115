"""The port's serving CLI (``python -m repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``) on the same arguments, on the CPU.

Both build the same synthetic corpus, Vamana graph and quantized base from
the seed, so the port's torch engine on the CPU must report the reference's
recall, I/Os per query, hit rate, disk and memory bytes, and print the same
metrics lines.  Without ``--device cpu`` the port asks for the CUDA card and
raises where there is none.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as ref_serve
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--n", "500", "--d", "32", "--queries", "24", "--L", "32"]
SAME = ("system", "recall@k", "ios_per_query", "hit_rate", "disk_bytes", "memory_bytes")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _metric_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("[serve] system=")
            or ln.startswith("[serve] disk=")]


@pytest.mark.parametrize("system", ["velo", "diskann", "pipeann"])
def test_serve_matches_the_reference(system, capsys):
    want = ref_serve.main(ARGS + ["--system", system])
    ref_lines = _metric_lines(capsys.readouterr().out)
    got = serve.main(ARGS + ["--system", system, "--device", "cpu"])
    lines = _metric_lines(capsys.readouterr().out)
    assert got["distance_backend"] == "torch"
    assert {k: got[k] for k in SAME} == {k: want[k] for k in SAME}
    assert len(lines) == 2 and lines[0].startswith(f"[serve] system={system} recall@10=")
    # the printed metrics are the reference's, field by field
    assert lines[1] == ref_lines[1]
    keep = ("system=", "recall@10=", "io/q=", "hit=")
    assert ([f for f in lines[0].split() if f.startswith(keep)]
            == [f for f in ref_lines[0].split() if f.startswith(keep)])


def test_serve_asks_for_the_card(monkeypatch):
    """No ``--device``: the torch engine asks for the CUDA card, and with none
    the CLI raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--n", "200", "--d", "16", "--queries", "4"])


def test_serve_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *ARGS, "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert len(_metric_lines(proc.stdout)) == 2, proc.stdout
