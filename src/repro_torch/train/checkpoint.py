"""Checkpointing with atomic writes, in the JAX package's layout.

Layout:  <dir>/step_<N>/
            manifest.json       — step, flat leaf index, shapes/dtypes
            arrays.npz          — one entry per flattened leaf path
         <dir>/LATEST           — atomically updated pointer

Leaf paths join dict keys and tuple indices with ``/`` (dict keys sorted,
as the reference flattens them), bfloat16 leaves are stored as their
uint16 bits with dtype ``"bfloat16"`` in the manifest, and the files are
written as the reference writes them, so a checkpoint written by either
package restores in the other.  Writes go to a temp dir + atomic rename so
a killed process never leaves a half-written checkpoint (launch/elastic.py
kills mid-run to prove it).

Under a mesh the state's leaves are DTensors: saving gathers each sharded
leaf to one full array (every rank takes part, rank 0 writes).  Restore is
*elastic*: arrays are loaded host-side and placed with ``shardings``, the
placements of the CURRENT mesh, which may differ from the mesh that saved
them; without ``shardings`` every leaf lands whole on ``device``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import sharding as Sh
from repro_torch.train import optimizer as Opt


def _paths(tree, prefix=()) -> list[tuple[str, object]]:
    """(path, leaf) pairs in ``Opt.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the array the file holds (bfloat16 as its uint16 bits) and
    the dtype the manifest names."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, state: dict) -> str:
    """Write ``state`` as step ``step``; DTensor leaves are gathered whole
    first (``Sh.full``), and with a process group up only rank 0 writes (the
    others wait for it)."""
    from torch.distributed.tensor import DTensor

    paths = _paths(state)
    sharded = any(isinstance(v, DTensor) for _, v in paths)
    paths = [(k, Sh.full(v)) for k, v in paths]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if sharded and dist.get_rank() != 0:
        dist.barrier()
        return final
    try:
        return _write(ckpt_dir, step, paths, final)
    finally:
        if sharded:
            dist.barrier()


def _write(ckpt_dir: str, step: int, paths, final: str) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    dtypes = {}
    for k, v in paths:
        arrays[k], dtypes[k] = _to_numpy(v)
    manifest = {
        "step": step,
        "leaves": {
            k: {"shape": list(a.shape), "dtype": dtypes[k]} for k, a in arrays.items()
        },
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["step"]


def restore(ckpt_dir: str, like: dict, device: str | torch.device = "cpu",
            shardings=None, mesh=None) -> tuple[dict, int]:
    """Restore into the structure of ``like`` (a tree of anything with a
    ``shape``: tensors, arrays), every leaf a tensor on ``device`` in the
    dtype it was saved with.  ``shardings``: a matching tree of DTensor
    placements on ``mesh`` (the active mesh by default): each leaf becomes a
    DTensor of those placements, every rank keeping its own slice."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, ref in _paths(like):
            arr = data[key]
            bf16 = manifest["leaves"].get(key, {}).get("dtype") == "bfloat16"
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} in the checkpoint, "
                                 f"{tuple(ref.shape)} expected")
            t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
            if bf16:
                t = t.view(torch.bfloat16)
            leaves.append(t.to(device))
    tree = Opt.tree_unflatten(like, leaves)
    if shardings is not None:
        tree = Sh.place(tree, mesh if mesh is not None else Sh.active_mesh(), shardings)
    return tree, step
