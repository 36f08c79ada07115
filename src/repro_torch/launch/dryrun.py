"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step as one
rank of the production mesh, the counterpart of the JAX package's
``launch/dryrun.py``.

For each cell:
  * build the production mesh (16x16 single-pod / 2x16x16 multi-pod) over a
    FAKE process group of the mesh's world size in this one process (its
    collectives return their output buffers), and arm it as the models'
    active mesh;
  * build the model and the parameter / optimizer / cache / batch
    placements from the specs (``models.sharding``), every tensor a meta
    tensor (no allocation);
  * run rank 0's part of the step (train: ``make_train_step``, the
    optimizer state placed by ``train_step.opt_state_placements``: AdamW's
    moments mirror their params, adamw8's codes are replicated; prefill;
    decode) under
    ``launch.trace_analysis.Trace``, which records its local FLOPs,
    op-boundary bytes, collectives and the peak of live temporaries ->
    launch/out/dryrun/<cell>.json, in the reference's record layout.

Memory is an ESTIMATE: XLA's memory analysis has no counterpart.  The
arguments (the local shards of params, moments, batch and caches) are
exact from the specs; the temporaries are the peak of live bytes over the
traced step (its outputs included: the port's optimizer returns new trees
beside the old, where the reference donates them).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--resume]
  python -m repro_torch.launch.dryrun --arch veloann --shape serve_batch
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shapes as shapes_mod
from repro_torch.launch import trace_analysis as TA
from repro_torch.models import model as Mod
from repro_torch.models import sharding as Sh
from repro_torch.train import optimizer as Opt
from repro_torch.train import train_step as TS

OUT_DIR = os.path.join(os.path.dirname(__file__), "out", "dryrun")


# ------------------------------------------------------------- the fake group


def fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process (rank
    0): collectives complete at once and move no data."""
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


# ----------------------------------------------------------- cache shardings


def cache_pspecs(model, caches_shape, dp, seq_len):
    """Specs for decode caches: batch over dp when divisible, else the KV
    sequence axis (long_500k), else the head/channel axis."""
    sizes = Sh.mesh_sizes()
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]

    def spec(path, leaf):
        shape = leaf.shape
        names = [str(e) for e in path]
        off = 1 if "groups" in names else 0
        field = names[-1]
        B = shape[off]
        out = [None] * len(shape)
        if field in ("k", "v", "ck", "cv"):
            S = shape[off + 2]
            if B % dp_size == 0 and B >= dp_size:
                out[off] = dp
            elif S % dp_size == 0:
                out[off + 2] = dp           # long-context: shard the sequence
            # KV heads never divide the 16-way model axis (kv in {1,4,8,12}),
            # so the model axis shards the SEQUENCE instead: decode attention
            # is a seq-reduction whose softmax partials are combined
            if S % sizes.get("model", 1) == 0 and out[off + 2] is None:
                out[off + 2] = "model"
        elif field in ("conv", "ssm"):
            if B % dp_size == 0 and B >= dp_size:
                out[off] = dp
            elif shape[off + (2 if field == "conv" else 1)] % sizes.get("model", 1) == 0:
                out[off + (2 if field == "conv" else 1)] = "model"
        elif field in ("tshift", "wkv", "cshift"):
            if B % dp_size == 0 and B >= dp_size:
                out[off] = dp
            elif field == "wkv" and shape[off + 1] % sizes.get("model", 1) == 0:
                out[off + 1] = "model"
        return tuple(out)

    return Sh.tree_map_with_path(lambda path, leaf: spec(path, leaf) if hasattr(leaf, "shape")
                                 else leaf, caches_shape)


# ------------------------------------------------------------------ the cell


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in Opt.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if torch.is_tensor(t):
            total += TA.tensor_bytes(t)
    return total


def _placed_batch(batch: dict, dmesh) -> dict:
    return {k: Sh.place(v, dmesh, Sh.batch_placements(dmesh, v.shape[0], v.dim()))
            for k, v in batch.items()}


def run_lm_cell(arch: str, shape: str, multi_pod: bool, microbatches: int | None,
                opt_name: str = "adamw", ce_chunk: int = 256, cell=None, mesh=None) -> dict:
    """One (arch x shape x mesh) cell.  ``cell`` (a ``shapes.CellSpec``) and
    ``mesh`` (a ``launch.mesh.Mesh``) replace the production shape and mesh
    when given."""
    cfg = configs.get(arch)
    if cell is None:
        reason = shapes_mod.skip_reason(cfg, shape)
        if reason:
            return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                    "status": "skipped", "reason": reason}
    mesh = mesh if mesh is not None else mesh_mod.make_production_mesh(multi_pod=multi_pod)
    fake_group(mesh_mod.n_devices(mesh))
    dp = mesh_mod.dp_axes(mesh)
    ndev = mesh_mod.n_devices(mesh)
    dmesh = mesh_mod.device_mesh(mesh, "cpu")
    Sh.set_active_mesh(dmesh, dp_axes=dp)
    try:
        model = Mod.build(cfg)
        cell = cell if cell is not None else shapes_mod.input_specs(cfg, model, shape)
        params_shape = Mod.params_specs(model)
        pspecs, degraded = Sh.check_divisible(params_shape, Sh.param_pspecs(params_shape), dmesh)
        psh = Sh.named(dmesh, pspecs)
        params = Sh.place(params_shape, dmesh, psh)

        t0 = time.time()
        if cell.kind == "train":
            opt_init, _ = Opt.OPTIMIZERS[opt_name]
            opt0 = opt_init(params_shape)
            opt = Sh.place(opt0, dmesh, TS.opt_state_placements(opt_name, opt0, psh, dmesh))
            batch = _placed_batch(cell.batch, dmesh)
            mb = microbatches or max(1, cell.global_batch // (ndev // mesh.sizes["model"]))

            def batch_shardings(ndim):
                return Sh.batch_placements(dmesh, cell.global_batch // mb, ndim)

            step_fn = TS.make_train_step(model, opt_name=opt_name, microbatches=mb,
                                         ce_chunk=ce_chunk, grad_pspecs=psh,
                                         batch_shardings=batch_shardings)
            args = (params, opt, batch)
            with TA.Trace() as tr:
                outs = step_fn(params, opt, batch)
        elif cell.kind == "prefill":
            batch = _placed_batch(cell.batch, dmesh)
            args = (params, batch)
            with torch.no_grad(), TA.Trace() as tr:
                outs = Mod.prefill(model, params, batch)
        else:  # decode
            cspecs = cache_pspecs(model, cell.caches, dp, cell.seq_len)
            caches = Sh.place(cell.caches, dmesh, Sh.named(dmesh, cspecs))
            B = cell.tokens.shape[0]
            lead = dp if B % ndev == 0 or B >= 16 else None
            tokens = Sh.place(cell.tokens, dmesh, Sh.placements_of(dmesh, (lead,)))
            args = (params, caches, tokens)
            with torch.no_grad(), TA.Trace() as tr:
                outs = Mod.decode_step(model, params, caches, tokens, cell.pos)
        trace_s = time.time() - t0
        mm = mesh.sizes
        out = _collect(tr.result(), arch, shape, multi_pod, ndev, cfg, args, outs)
        out.update(trace_s=round(trace_s, 1), degraded_shardings=degraded[:20],
                   kind=cell.kind, seq_len=cell.seq_len, global_batch=cell.global_batch,
                   mesh=dict(mm))
        if cell.kind == "train":
            out["microbatches"] = mb
        return out
    finally:
        Sh.clear_active_mesh()


def run_veloann_cell(multi_pod: bool) -> dict:
    """The serving cell: each rank scans its shard of the corpus with the
    plain stage-1 product (the reference traces its jnp path too) and the
    shards' top-k are merged by one all-gather."""
    from repro_torch.velo import dist_search
    from repro_torch.velo.index import synthetic_specs

    vcfg = configs.get("veloann")
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    ndev = mesh_mod.n_devices(mesh)
    fake_group(ndev)
    per_shard = vcfg.corpus_size // ndev
    idx = synthetic_specs(per_shard, vcfg.dim, vcfg.R)
    queries = torch.empty((vcfg.query_batch, vcfg.dim), dtype=torch.float32, device="meta")
    search = dist_search.make_distributed_search(mode="scan_ref", L=vcfg.rerank, k=vcfg.k)
    t0 = time.time()
    with torch.no_grad(), TA.Trace() as tr:
        outs = search(idx, 0, queries)
        # dist_search gathers through torch.distributed itself: one
        # all-gather each of the (B, k) ids and distances over every rank
        for t in outs:
            tr.records.append(("all-gather", TA.tensor_bytes(t), TA.tensor_bytes(t) * ndev, ndev))
    trace_s = time.time() - t0
    out = _collect(tr.result(), "veloann", "serve_batch", multi_pod, ndev, None,
                   (idx, queries), outs)
    out.update(trace_s=round(trace_s, 1), kind="serve", seq_len=0,
               global_batch=vcfg.query_batch)
    return out


def _collect(res: dict, arch, shape, multi_pod, ndev, cfg, args, outs) -> dict:
    arg_b = _local_bytes(args)
    out_b = _local_bytes(outs)
    rec = {
        "arch": arch,
        "shape": shape,
        "multi_pod": multi_pod,
        "status": "ok",
        "n_devices": ndev,
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": res["temp_peak_bytes"],
            "alias_bytes": 0,
            # an estimate: exact arguments + the traced step's live peak
            # (which holds its outputs)
            "peak_estimate_bytes": arg_b + res["temp_peak_bytes"],
        },
        "cost": {
            "flops_per_device": res["flops_per_device"],
            "bytes_accessed_per_device": res["bytes_per_device"],
            "ops_executed": res["ops_executed"],
        },
        "collectives": res["collectives"],
    }
    if cfg is not None:
        rec["model"] = {"params": cfg.params_count(), "active_params": cfg.active_params_count()}
    return rec


def cell_path(arch, shape, multi_pod):
    pod = "pod2" if multi_pod else "pod1"
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{pod}.json")


def run_and_save(arch, shape, multi_pod, **kw):
    os.makedirs(OUT_DIR, exist_ok=True)
    path = cell_path(arch, shape, multi_pod)
    t0 = time.time()
    try:
        if arch == "veloann":
            rec = run_veloann_cell(multi_pod)
        else:
            rec = run_lm_cell(arch, shape, multi_pod, kw.get("microbatches"))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec = {
            "arch": arch, "shape": shape, "multi_pod": multi_pod,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    rec["wall_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        mem = rec["memory"]["peak_estimate_bytes"] / 2**30
        extra = (f" mem/dev={mem:.2f}GiB flops/dev={rec['cost']['flops_per_device']:.3g} "
                 f"trace={rec.get('trace_s')}s")
    elif status == "error":
        extra = " " + rec["error"][:200]
    print(f"[dryrun] {arch} {shape} {'pod2' if multi_pod else 'pod1'}: {status}{extra}",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    if args.all:
        for arch in configs.all_archs():
            for shape in shapes_mod.SHAPES:
                for mp in meshes:
                    cells.append((arch, shape, mp))
        for mp in meshes:
            cells.append(("veloann", "serve_batch", mp))
    else:
        if not args.arch:
            ap.error("--arch or --all")
        shapes = [args.shape] if args.shape else list(shapes_mod.SHAPES)
        if args.arch == "veloann":
            shapes = ["serve_batch"]
        for shape in shapes:
            for mp in meshes:
                cells.append((args.arch, shape, mp))

    for arch, shape, mp in cells:
        if args.resume and os.path.exists(cell_path(arch, shape, mp)):
            with open(cell_path(arch, shape, mp)) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    continue
        run_and_save(arch, shape, mp, microbatches=args.microbatches)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
