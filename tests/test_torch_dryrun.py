"""The dry run's trace analysis against the JAX package's HLO analysis, and
one production cell on a fake process group of 256 ranks.

The reference parses compiled HLO; the port traces an eager step.  Held
equal: the ring accounting of each collective kind (one hand-written HLO
line each, through the reference's ``collective_stats``), byte counts of a
shape and dtype (its ``_shape_bytes``), FLOPs of loops (a 64-iteration loop
counted 64 times, as the reference's trip-count correction intends), and
the per-device argument bytes of ``rwkv6-7b long_500k pod1`` (the reference's
own test cell) and of an adamw8 train cell of TinyLlama-1.1B on a 2 x 2
mesh (every adamw8 state leaf whole on every device, the reference's
``P()``) from the reference's specs.
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as H
from repro_torch.launch import trace_analysis as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HLO = {
    "all-gather": ("f32[1024]", "f32[4096]", "all-gather", "dimensions={0}"),
    "all-reduce": ("bf16[1024]", "bf16[1024]", "all-reduce", "to_apply=%add"),
    "reduce-scatter": ("f32[4096]", "f32[1024]", "reduce-scatter", "dimensions={0}"),
    "all-to-all": ("bf16[2048]", "bf16[2048]", "all-to-all", "dimensions={0}"),
    "collective-permute": ("f32[512]", "f32[512]", "collective-permute",
                           "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}"),
}


def _hlo_line(kind: str) -> str:
    ins, outs, op, attr = _HLO[kind]
    return textwrap.dedent(f"""\
        HloModule m
        ENTRY %main (p0: {ins}) -> {outs} {{
          %p0 = {ins}{{0}} parameter(0)
          ROOT %c = {outs}{{0}} {op}({ins}{{0}} %p0), replica_groups={{{{0,1,2,3}}}}, {attr}
        }}
        """)


_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "s8": torch.int8, "s32": torch.int32,
       "pred": torch.bool, "u8": torch.uint8, "s64": torch.int64, "f16": torch.float16}


def _meta(text: str) -> torch.Tensor:
    dt, dims = text.split("[")
    shape = [int(d) for d in dims.rstrip("]").split(",") if d]
    return torch.empty(shape, dtype=_DT[dt], device="meta")


@pytest.mark.parametrize("kind", list(_HLO))
def test_ring_accounting_matches_the_reference(kind):
    ins, outs, _, _ = _HLO[kind]
    want = H.collective_stats(_hlo_line(kind), 4)
    got = TA.collective_stats([(kind, TA.tensor_bytes(_meta(ins)),
                                TA.tensor_bytes(_meta(outs)), 4)])
    assert want["counts"] == {kind: 1.0}
    assert got == want


@pytest.mark.parametrize("text", ["f32[4,4]", "bf16[2,3]", "pred[10]", "s8[7,3,2]", "s32[5]",
                                  "u8[1000000,16]", "f16[3]", "s64[2,2]"])
def test_byte_counts_match_shape_bytes(text):
    assert TA.tensor_bytes(_meta(text)) == H._shape_bytes(text)


def test_a_64_iteration_loop_counts_64_times():
    w = torch.empty(128, 128, device="meta")
    with TA.Trace() as tr:
        h = torch.empty(8, 128, device="meta")
        for _ in range(64):
            h = torch.tanh(h @ w)
        h.sum()
    assert tr.result()["flops_per_device"] == 2 * 8 * 128 * 128 * 64


def test_nested_loops_count_every_iteration():
    w = torch.empty(64, 64, device="meta")
    with TA.Trace() as tr:
        h = torch.empty(4, 64, device="meta")
        for _ in range(8):
            for _ in range(4):
                h = torch.tanh(h @ w)
    res = tr.result()
    assert res["flops_per_device"] == 2 * 4 * 64 * 64 * 4 * 8
    # op-boundary bytes: each matmul reads h and w and writes h, each tanh
    # reads and writes h
    hb, wb = 4 * 64 * 4, 64 * 64 * 4
    assert res["bytes_per_device"] == 32 * (hb + wb + hb) + 32 * 2 * hb


def test_live_bytes_peak_follows_the_tensors():
    """Each ``a * 2`` replaces a 4 000-byte tensor (two live at the op), then
    five more are kept beside the last: the peak is six of them."""
    with TA.Trace() as tr:
        a = torch.empty(1000, device="meta")
        for _ in range(10):
            a = a * 2
        keep = [torch.zeros(1000, device="meta") for _ in range(5)]
    assert tr.result()["temp_peak_bytes"] == 4000 * 6 and len(keep) == 5


_CELL = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    import repro_torch.launch.dryrun as dryrun
    assert not dist.is_initialized()          # importing it starts no group
    rec = dryrun.run_and_save("rwkv6-7b", "long_500k", False)
    assert dist.get_world_size() == 256 and dist.get_backend() == "fake"
    print(json.dumps(rec))
""")


def _reference_argument_bytes() -> int:
    """Per-device bytes of the params, caches and tokens of the cell, from
    the reference's specs at 16 x 16 (its scalar ``pos`` argument is a
    Python int in the port and is left out)."""
    import jax

    from repro import configs as ref_configs
    from repro.launch import shapes as ref_shapes
    from repro.models import model as ref_model
    from repro.models import sharding as ref_sh

    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref_dryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags

    mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((16, 16)))
    sizes = {"data": 16, "model": 16}
    cfg = ref_configs.get("rwkv6-7b")
    model = ref_model.build(cfg)
    params = ref_model.params_specs(model)
    pspecs, _ = ref_sh.check_divisible(params, ref_sh.param_pspecs(params), mesh)
    cell = ref_shapes.input_specs(cfg, model, "long_500k")
    ref_sh.set_active_mesh(mesh, dp_axes=("data",))
    try:
        cspecs = ref_dryrun.cache_pspecs(model, cell.caches, ("data",), cell.seq_len)
    finally:
        ref_sh.clear_active_mesh()

    def local_bytes(leaves, specs):
        total = 0
        for leaf, spec in zip(leaves, specs):
            n = 1
            for i, dim in enumerate(leaf.shape):
                axes = spec[i] if i < len(spec) else None
                axes = () if axes is None else (axes if isinstance(axes, tuple) else (axes,))
                n *= dim // int(np.prod([sizes[a] for a in axes]))
            total += n * np.dtype(leaf.dtype).itemsize
        return total

    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return (local_bytes(jax.tree.leaves(params), jax.tree.leaves(pspecs, is_leaf=is_spec))
            + local_bytes(jax.tree.leaves(cell.caches), jax.tree.leaves(cspecs, is_leaf=is_spec))
            + 4)  # the (1,) int32 tokens, replicated


def test_production_cell_on_a_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _CELL], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 256
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["memory"]["peak_estimate_bytes"] < 80 * 2**30
    assert rec["memory"]["argument_bytes"] == _reference_argument_bytes()
    assert rec["collectives"]["collective_bytes_per_device"] > 0
    path = os.path.join(ROOT, "src", "repro_torch", "launch", "out", "dryrun",
                        "rwkv6-7b__long_500k__pod1.json")
    with open(path) as f:
        assert json.load(f)["status"] == "ok"


_ADAMW8_CELL = textwrap.dedent("""
    import json
    from repro_torch.launch import dryrun, mesh as mesh_mod, shapes
    B, S = %(B)d, %(S)d
    batch = {"tokens": shapes.S((B, S), shapes.I32), "labels": shapes.S((B, S), shapes.I32)}
    cell = shapes.CellSpec(kind="train", batch=batch, seq_len=S, global_batch=B)
    print(json.dumps(dryrun.run_lm_cell("tinyllama-1.1b", "adamw8", False, 1, opt_name="adamw8",
                                        cell=cell, mesh=mesh_mod.Mesh((2, 2), ("data", "model")))))
""")
ADAMW8_B, ADAMW8_S = 4, 64


def _reference_adamw8_argument_bytes() -> int:
    """Per-device bytes of TinyLlama-1.1B's params by the reference's specs at
    2 x 2, its adamw8 state whole, and the (B, S) int32 tokens and labels
    with their rows over 'data'."""
    import jax

    from repro import configs as ref_configs
    from repro.models import model as ref_model
    from repro.models import sharding as ref_sh
    from repro.train import optimizer as ref_opt

    mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((2, 2)))
    sizes = {"data": 2, "model": 2}
    params = ref_model.params_specs(ref_model.build(ref_configs.get("tinyllama-1.1b")))
    pspecs, _ = ref_sh.check_divisible(params, ref_sh.param_pspecs(params), mesh)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    total = 0
    for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(pspecs, is_leaf=is_spec)):
        n = 1
        for i, dim in enumerate(leaf.shape):
            axes = spec[i] if i < len(spec) else None
            axes = () if axes is None else (axes if isinstance(axes, tuple) else (axes,))
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        total += n * np.dtype(leaf.dtype).itemsize
    state = jax.eval_shape(ref_opt.OPTIMIZERS["adamw8"][0], params)
    total += sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                 for x in jax.tree.leaves(state))
    return total + 2 * (ADAMW8_B // 2) * ADAMW8_S * 4


def test_adamw8_train_cell_places_its_state_whole():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c",
                           _ADAMW8_CELL % dict(B=ADAMW8_B, S=ADAMW8_S)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 4 and rec["cost"]["flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] == _reference_adamw8_argument_bytes()
