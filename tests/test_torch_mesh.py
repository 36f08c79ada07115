"""The port's mesh plans against the JAX package's, at full width: parameter
specs, the leaves that degrade to replication, decode-cache specs, the
dry run's input specs and skip reasons, and the roofline's model FLOPs.

The reference's ``check_divisible`` and ``cache_pspecs`` read only a mesh's
``axis_names`` and ``devices.shape``, so a ``SimpleNamespace`` stands in for
its mesh and no device is touched.  Its ``launch.dryrun`` sets the
512-device XLA flag when imported; the flag is put back as it was at once,
before JAX can read it.
"""

import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import sharding as ref_sh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_mod, roofline, shapes  # noqa: E402
from repro_torch.models import model as Mod  # noqa: E402
from repro_torch.models import sharding as Sh  # noqa: E402

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ARCHS = configs.all_archs()
MESHES = {"pod1": False, "pod2": True}


def _ref_mesh(multi_pod: bool):
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _ref_paths(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {ref_sh._path_str(p): leaf for p, leaf in leaves}


def _port_paths(tree, path=()) -> dict:
    """Joined path -> leaf; a spec (a tuple of axis names / None) is a leaf."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_paths(tree[key], path + (key,)).items()}
    if isinstance(tree, (tuple, list)) and (not tree or not Sh._is_spec(tree)):
        return {k: v for i, x in enumerate(tree) for k, v in _port_paths(x, path + (i,)).items()}
    return {Sh._path_str(path): tree}


def _pspec(p) -> tuple:
    """A spec as a tuple without trailing ``None``s (both mean replicated
    there), an entry of one axis name in a tuple as the name (the
    reference's ``PartitionSpec`` takes ("data",) for "data")."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in p]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_specs(arch):
    model = ref_model.build(ref_configs.get(arch))
    return model, ref_model.params_specs(model)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_leaf_for_leaf(arch):
    """Every parameter's path, shape, dtype and spec equal the reference's."""
    model = Mod.build(configs.get(arch))
    mine = Mod.params_specs(model)
    assert all(t.device.type == "meta" for t in _port_paths(mine).values())
    _, ref = _ref_specs(arch)
    ref_leaves, mine_leaves = _ref_paths(ref), _port_paths(mine)
    assert list(ref_leaves) == list(mine_leaves) or set(ref_leaves) == set(mine_leaves)
    for k, r in ref_leaves.items():
        assert tuple(mine_leaves[k].shape) == tuple(r.shape), k
        assert str(mine_leaves[k].dtype)[6:] == str(r.dtype), k
    ref_p = _ref_paths(ref_sh.param_pspecs(ref))
    mine_p = _port_paths(Sh.param_pspecs(mine))
    assert {k: _pspec(v) for k, v in ref_p.items()} == {k: _pspec(v) for k, v in mine_p.items()}


@pytest.mark.parametrize("pod", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_degraded_leaves_match_the_reference(arch, pod):
    """The leaves that fall back to replication, and every fixed spec, at
    16x16 and 2x16x16."""
    multi = MESHES[pod]
    _, ref = _ref_specs(arch)
    ref_fixed, ref_bad = ref_sh.check_divisible(ref, ref_sh.param_pspecs(ref), _ref_mesh(multi))
    mine = Mod.params_specs(Mod.build(configs.get(arch)))
    fixed, bad = Sh.check_divisible(mine, Sh.param_pspecs(mine),
                                    mesh_mod.make_production_mesh(multi_pod=multi))
    assert sorted(bad) == sorted(ref_bad)
    assert {k: _pspec(v) for k, v in _ref_paths(ref_fixed).items()} == \
        {k: _pspec(v) for k, v in _port_paths(fixed).items()}


def _decode_cells():
    return [(a, s, pod) for a in ARCHS for s, sh in shapes.SHAPES.items()
            if sh["kind"] == "decode" and shapes.skip_reason(configs.get(a), s) is None
            for pod in MESHES]


@pytest.mark.parametrize("arch,shape,pod", _decode_cells())
def test_cache_specs_match_the_reference(arch, shape, pod):
    multi = MESHES[pod]
    sh = shapes.SHAPES[shape]
    rmodel = ref_model.build(ref_configs.get(arch))
    rcaches = ref_shapes.decode_cache_specs(rmodel, sh["global_batch"], sh["seq_len"])
    rmesh = _ref_mesh(multi)
    dp = tuple(a for a in rmesh.axis_names if a in ("pod", "data"))
    ref_sh.set_active_mesh(rmesh, dp_axes=dp)
    try:
        want = ref_dryrun.cache_pspecs(rmodel, rcaches, dp, sh["seq_len"])
    finally:
        ref_sh.clear_active_mesh()
    model = Mod.build(configs.get(arch))
    caches = shapes.decode_cache_specs(model, sh["global_batch"], sh["seq_len"])
    Sh.set_active_mesh(mesh_mod.make_production_mesh(multi_pod=multi), dp_axes=dp)
    try:
        got = dryrun.cache_pspecs(model, caches, dp, sh["seq_len"])
    finally:
        Sh.clear_active_mesh()
    assert {k: _pspec(v) for k, v in _ref_paths(want).items()} == \
        {k: _pspec(v) for k, v in _port_paths(got).items()}
    ref_leaves, mine = _ref_paths(rcaches), _port_paths(caches)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref_leaves.items()} == \
        {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in mine.items()}


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_skip_reasons(arch, shape):
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    assert shapes.skip_reason(cfg, shape) == ref_shapes.skip_reason(rcfg, shape)
    assert shapes.cache_len_for(512, 32768) == ref_shapes.cache_len_for(512, 32768)
    mine = shapes.input_specs(cfg, Mod.build(cfg), shape)
    ref = ref_shapes.input_specs(rcfg, ref_model.build(rcfg), shape)
    assert (mine.kind, mine.pos, mine.seq_len, mine.global_batch) == \
        (ref.kind, ref.pos, ref.seq_len, ref.global_batch)

    def sig(tree, paths):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in paths(tree).items()}

    assert sig(mine.batch, _port_paths) == sig(ref.batch, _ref_paths)
    if ref.kind == "decode":
        assert sig(mine.caches, _port_paths) == sig(ref.caches, _ref_paths)
        assert (tuple(mine.tokens.shape), mine.tokens.dtype) == \
            (tuple(ref.tokens.shape), torch.int32)
        assert ref.tokens.dtype == jnp.int32


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_model_flops_and_analyze(kind):
    rec = {"arch": "yi-6b", "shape": "x", "multi_pod": False, "status": "ok",
           "n_devices": 256, "kind": kind, "global_batch": 256, "seq_len": 4096,
           "model": {"params": 6_000_000_000, "active_params": 6_000_000_000},
           "memory": {"peak_estimate_bytes": 20 * 2**30},
           "cost": {"flops_per_device": 1.0e15, "bytes_accessed_per_device": 1.0e13},
           "collectives": {"collective_bytes_per_device": 2.0e11}}
    assert roofline.model_flops_per_device(rec) == ref_roofline.model_flops_per_device(rec)
    row = roofline.analyze(rec)
    assert row["model_flops_per_device"] == ref_roofline.analyze(rec)["model_flops_per_device"]
    assert row["t_compute_s"] == 1.0e15 / 989e12
    assert row["t_memory_s"] == 1.0e13 / 3.35e12
    assert row["t_collective_s"] == 2.0e11 / 450e9
    assert row["dominant"] == "memory" and row["fits_hbm_80g"]
    assert row["roofline_fraction"] == row["t_compute_s"] / row["t_memory_s"]
    table = roofline.markdown_table([row, roofline.analyze(dict(rec, status="skipped",
                                                                reason="why"))])
    assert "fits 80G" in table and "why" in table
