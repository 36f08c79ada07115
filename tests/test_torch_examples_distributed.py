"""examples/distributed_search_torch.py against examples/distributed_search.py
on the CPU.

The reference shards its 4 096 x 64 corpus over 8 virtual XLA devices
(``shard_map``) in a subprocess, where the merged ids are taken from its
own call to ``recall_at_k``; the twin's 8 gloo ranks hold the same 8
shards, each with its own local graph of the same seed.  Held: the merged
ids equal, and the printed lines.
"""

import contextlib
import importlib
import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = textwrap.dedent("""
    import importlib.util, sys
    import numpy as np
    spec = importlib.util.spec_from_file_location("distributed_search",
                                                  "examples/distributed_search.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    recall = mod.recall_at_k

    def spy(ids, groundtruth, k):
        np.save(sys.argv[1], ids)
        return recall(ids, groundtruth, k)

    mod.recall_at_k = spy
    mod.main()
""")


@pytest.fixture(scope="module")
def example():
    sys.path.insert(0, str(ROOT / "examples"))  # the ranks import the twin by name
    try:
        yield importlib.import_module("distributed_search_torch")
    finally:
        sys.path.remove(str(ROOT / "examples"))


@pytest.fixture(scope="module")
def runs(example, tmp_path_factory):
    path = tmp_path_factory.mktemp("distributed") / "ids.npy"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(path)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ids, rec = example.main(["--device", "cpu"])
    ref_out, ref_err = ref.communicate(timeout=300)
    assert ref.returncode == 0, ref_err[-3000:]
    return dict(ids=np.load(path), lines=ref_out.splitlines()), \
        dict(ids=ids, recall=rec, lines=out.getvalue().splitlines())


def test_merged_ids_equal_the_references(runs):
    ref, port = runs
    assert port["ids"].shape == ref["ids"].shape == (64, 10)
    np.testing.assert_array_equal(port["ids"], ref["ids"])


def test_printed_lines_equal_the_references(runs):
    ref, port = runs
    assert port["lines"] == ref["lines"]
    assert port["lines"][0].startswith("devices=8 corpus=4096") and port["lines"][-1] == "OK"


def test_main_defaults_to_the_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([])
