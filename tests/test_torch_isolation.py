"""The port stands alone: it imports neither ``jax`` nor the JAX package,
nor ``ml_dtypes`` (bfloat16 arrays travel as their uint16 bits).

A subprocess whose ``sys.modules`` poisons ``jax``, ``repro`` and
``ml_dtypes`` (an import of any raises) imports every module of
``repro_torch`` and runs a 200-vector VeloANN search on the CPU.  A scan of the port's sources, of
``chip_smoke.py`` and of the torch twins of the examples finds no import of any of them.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHILD = r"""
import sys
sys.modules["jax"] = None      # any import of jax / repro / ml_dtypes now raises
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import importlib, pkgutil
import torch
torch.set_num_threads(1)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.core import baselines, dataset, vamana
from repro_torch.core.quant import RabitQuantizer
ds = dataset.make_dataset(n=200, d=32, n_queries=8, k=5, seed=1)
graph = vamana.build_vamana(ds.base, R=8, L=16, seed=1)
qb = RabitQuantizer(ds.dim, seed=1).fit_encode(ds.base)
cfg = baselines.SystemConfig(buffer_ratio=0.3, batch_size=4, device="cpu",
                             fuse=True, device_beam=True,
                             params=baselines.SearchParams(L=16, W=2))
out = baselines.evaluate(baselines.build_system("velo", ds.base, graph, qb, cfg), ds)
assert out["distance_backend"] == "torch" and out["recall@k"] > 0.5, out
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m, mod in sys.modules.items() if mod is not None)
print("modules", len(names), "recall", out["recall@k"])
print(" ".join(names))
"""

# modules added after the first slice, which the walk above must import
NEW_MODULES = ("core.workload", "core.serving", "velo.index", "velo.batch_search",
               "velo.scan_search", "velo.dist_search", "analysis.registry",
               "analysis.spec", "analysis.lint", "analysis.protocol",
               "analysis.explore", "analysis.__main__", "launch.serve",
               "configs.yi_6b", "configs.granite_20b",
               "configs.tinyllama_1_1b", "configs.gemma3_1b", "configs.jamba_v0_1_52b",
               "configs.kimi_k2_1t_a32b", "configs.dbrx_132b",
               "configs.llava_next_mistral_7b", "configs.whisper_small",
               "configs.rwkv6_7b", "configs.veloann",
               "models.config", "models.layers", "models.moe", "models.mamba",
               "models.rwkv", "models.blocks", "models.model", "convert",
               "train.data", "train.optimizer", "train.train_step", "train.checkpoint",
               "launch.train", "launch.elastic", "models.sharding", "launch.mesh",
               "launch.shapes", "launch.trace_analysis", "launch.dryrun", "launch.roofline",
               "tracing")

_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s)"
                     r"|import\s+ml_dtypes\b|from\s+ml_dtypes\b)", re.MULTILINE)


def test_port_runs_with_jax_and_repro_poisoned():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split()[1])
    assert n_modules >= 30, proc.stdout
    walked = set(proc.stdout.splitlines()[1].split())
    assert {f"repro_torch.{m}" for m in NEW_MODULES} <= walked, proc.stdout


# the examples' torch twins
EXAMPLES = ("quickstart_torch", "serve_batch_torch", "distributed_search_torch",
            "rag_serving_torch", "train_lm_torch")


def test_no_jax_or_repro_import_in_the_port_sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + [ROOT / "examples" / f"{name}.py" for name in EXAMPLES])
    assert all(f.exists() for f in files)
    assert {PORT / (m.replace(".", "/") + ".py") for m in NEW_MODULES} <= set(files)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert hits == []
    # the scan itself finds what it is looking for
    assert _IMPORT.search("from repro.core import quant") and _IMPORT.search("import jax.numpy")
    assert _IMPORT.search("    import ml_dtypes")
    assert not _IMPORT.search("from repro_torch.core import quant")
