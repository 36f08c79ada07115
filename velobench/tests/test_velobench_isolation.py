"""Nothing the benchmark runs loads JAX or the JAX package (``repro``), by
whole top-level names (the port's name, ``repro_torch``, begins with
``repro``); the reference loads nothing of the port; and the command gives
no result without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "velobench"

PROBE = """
import importlib.util, json, sys
sys.path[:0] = [{repo!r}, {src!r}]
spec = importlib.util.spec_from_file_location("velobench_run", {run!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from velobench import harness, registry
for kind in ("drivers", "metrics"):
    for path in sorted(registry.HERE.joinpath(kind).glob("*.py")):
        getattr(registry, kind[:-1])(path.stem)
import velobench.index_cache, velobench.readings
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_after(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_no_jax():
    names = _top_level_after(PROBE.format(repo=str(REPO), src=str(REPO / "src"),
                                          run=str(BENCH / "run.py")))
    assert "repro_torch" in names and "velobench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path[:0] = [{!r}]\n"
            "import velobench.reference.exact, velobench.reference.rabitq, "
            "velobench.reference.scan\n"
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))").format(str(REPO))
    names = _top_level_after(code)
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for m in mods:
                assert m.split(".")[0] in {"velobench", "numpy", "torch", "math", "dataclasses",
                                           "contextlib", "__future__"}, (path.name, m)


def test_forbidden_modules_compares_whole_names():
    sys.path.insert(0, str(REPO))
    from velobench import harness

    saved = dict(sys.modules)
    try:
        for m in harness.forbidden_modules():
            del sys.modules[m]
        sys.modules["repro_torch_probe"] = sys
        sys.modules["jaxtyping_probe"] = sys
        assert harness.forbidden_modules() == []
        sys.modules["repro.core"] = sys
        assert harness.forbidden_modules() == ["repro.core"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_command_gives_no_result_without_the_card():
    import torch

    if torch.cuda.is_available():
        return  # the card's own run is the chip's to check
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "veloann-scan.b4096", "--seed", str(2**31 + 1), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
