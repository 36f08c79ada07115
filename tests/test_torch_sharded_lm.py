"""The port's LM stack under a mesh, on four gloo ranks (a 2 x 2 data x model
mesh), for the reduced Yi-6B, TinyLlama, dbrx, RWKV-6 and Jamba in fp32
(rwkv's heads and jamba's mamba channels split over 'model'; and whisper's
encoder-decoder and llava's vision front end, served only): serving
(prefill plus 4 greedy decode steps, caches placed by ``cache_pspecs``)
against the unsharded port, 3 AdamW steps of 2 microbatches against the unsharded port
and against the JAX package's sharded train step on ``make_test_mesh(4, 2)``,
and a checkpoint saved under (2 x 2) restored under (4 x 1) and unsharded.

The weights are the reference's ``init_params`` (a subprocess writes them);
the reference's train step runs in a second subprocess with four XLA CPU
devices while the port's ranks run, on the same batches: both cut
microbatch i from rows i*mb .. of the global batch and split it over the DP
axis.

dbrx and jamba: under EP a DP row's tokens have their own capacity and
their own aux loss (the reference's ``moe_ffn_ep``), so their sharded step
is not the unsharded one.  Their serving runs at a capacity factor of E (no
pair is dropped, so the outputs are the unsharded ones) and their training
is held to the reference's sharded step only.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.train import data as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("yi-6b", "tinyllama-1.1b", "dbrx-132b", "rwkv6-7b", "jamba-v0.1-52b")
DENSE = ["yi-6b", "tinyllama-1.1b", "rwkv6-7b"]
# served only: the encoder-decoder (cross attention over a sequence-split
# cache) and the vision front end
SERVE_ONLY = ("whisper-small", "llava-next-mistral-7b")
B, S, STEPS, MB = 8, 32, 3, 2        # train: 8 x 32 tokens, 3 steps of 2 microbatches
SB, SS, DECODE = 4, 16, 4            # serve: 4 prompts of 16 tokens, 4 decode steps


def _batches(cfg):
    """The steps' batches, with the labels of rows 2 and 3 past position 8
    ignored: microbatches then count different numbers of labels, so a
    microbatch cut from other rows than the reference's changes the loss."""
    dcfg = D.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    out = [D.batch_for_step(dcfg, s) for s in range(STEPS)]
    for b in out:
        b["labels"] = b["labels"].copy()
        b["labels"][2:4, 8:] = -100
    return out


_REF_INIT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax
    from repro import configs
    from repro.models import model as Mod, sharding as Sh
    for arch in sys.argv[2:]:
        cfg = dataclasses.replace(configs.get(arch, reduced=True), dtype="float32")
        params = Mod.init_params(Mod.build(cfg), jax.random.key(0))
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        np.savez(f"{sys.argv[1]}/{arch}.params.npz",
                 **{Sh._path_str(p): np.asarray(v) for p, v in flat})
""")

_REF_TRAIN = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import mesh as mesh_mod
    from repro.models import model as Mod, sharding as Sh
    from repro.train import optimizer as Opt, train_step as TS
    tmp = sys.argv[1]
    mesh = mesh_mod.make_test_mesh(4, 2)
    Sh.set_active_mesh(mesh, dp_axes=("data",))
    dp = ("data",)
    out = {}
    for arch in sys.argv[2:]:
        cfg = dataclasses.replace(configs.get(arch, reduced=True), dtype="float32")
        model = Mod.build(cfg)
        params = Mod.init_params(model, jax.random.key(0))
        pspecs, _ = Sh.check_divisible(params, Sh.param_pspecs(params), mesh)
        psh = Sh.named(mesh, pspecs)
        opt_init, _ = Opt.OPTIMIZERS["adamw"]
        opt = opt_init(params)
        osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}
        bsh = NamedSharding(mesh, P(dp, None))
        oc = Opt.OptConfig(lr=1e-3, total_steps=%(steps)d, warmup_steps=1)
        step = TS.make_train_step(
            model, "adamw", oc, microbatches=%(mb)d, ce_chunk=16, grad_pspecs=psh,
            batch_shardings=lambda nd: NamedSharding(mesh, P(None, dp, *([None] * (nd - 2)))))
        jitted = jax.jit(step, in_shardings=(psh, osh, {"tokens": bsh, "labels": bsh}),
                         out_shardings=(psh, osh, None))
        params, opt = jax.device_put(params, psh), jax.device_put(opt, osh)
        z = np.load(f"{tmp}/{arch}.batches.npz")
        losses = []
        for s in range(%(steps)d):
            b = {k: jnp.asarray(z[f"{s}|{k}"]) for k in ("tokens", "labels")}
            params, opt, m = jitted(params, opt, b)
            losses.append(float(m["loss"]))
        out[arch] = losses
    json.dump(out, open(f"{tmp}/ref_losses.json", "w"))
""") % dict(steps=STEPS, mb=MB)

_PORT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    B, S, STEPS, MB, SB, SS, DECODE = %(consts)s
    SERVE_ONLY = %(serve_only)s


    def load_params(model, path):
        from repro_torch.models import model as M, sharding as Sh
        z = np.load(path)
        like = M.params_specs(model)
        return Sh.tree_map_with_path(
            lambda p, leaf: torch.from_numpy(z[Sh._path_str(p)]).to(leaf.dtype), like)


    def serve(M, model, params, batch, place=None, dm=None):
        from repro_torch.launch import dryrun
        from repro_torch.models import sharding as Sh
        cfg = model.cfg
        B = batch["tokens"].shape[0]
        s_full = SS + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        enc = cfg.encoder_tokens if cfg.n_encoder_layers else 0
        put = place or (lambda t: t)
        with torch.no_grad():
            logits, pc = M.prefill(model, params, {k: put(v) for k, v in batch.items()})
            caches = M.init_decode_caches(model, B, s_full + DECODE, enc_len=enc, device="cpu")
            if dm is not None:
                specs = dryrun.cache_pspecs(model, caches, ("data",), s_full + DECODE)
                caches = Sh.place(caches, dm, Sh.named(dm, specs))
            caches = M.load_prefill_caches(caches, pc, model)
            gather = (lambda t: Sh.all_gather(t, "data", 0)) if dm is not None else (lambda t: t)
            out = [gather(logits)]
            tok = out[0].argmax(-1)
            for i in range(DECODE):
                logits, caches = M.decode_step(model, params, caches, put(tok), s_full + i)
                out.append(gather(logits))
                tok = out[-1].argmax(-1)
        return out


    def recurrent_block(cfg, params, dm):
        # rwkv's time and channel mix, or jamba's mamba, at unit-scale
        # inputs (where ln_x's mean square outweighs its eps): this rank's
        # channels under the mesh against the whole block, for the sequence
        # path, its gradients and one decode step.  Returns the largest
        # errors relative to each compared tensor's largest entry.
        from repro_torch.models import mamba as Mb, rwkv as R, sharding as Sh
        kind = "rwkv" if any("rwkv" in g for g in params["groups"]) else "mamba"
        slot = next(g for g in params["groups"] if kind in g)
        p = {k: v[0].clone() for k, v in slot[kind].items()}
        g = torch.Generator().manual_seed(7)
        x = torch.randn((2 * SB, SS, cfg.d_model), generator=g)
        c = torch.randn((2 * SB, SS, cfg.d_model), generator=g)
        dpi = dm.get_local_rank("data")

        def run(p, x, split):
            if kind == "rwkv":
                return (R.time_mix_seq(p, x, cfg.n_heads, split=split)
                        + R.channel_mix_seq(p, x, split))
            return Mb.mamba_seq(p, x, split=split)

        def step(p, x, state, split):
            if kind == "rwkv":
                ts, wkv, out = R.time_mix_decode(p, state[0], state[1], x, cfg.n_heads, split)
                cs, out2 = R.channel_mix_decode(p, state[2], x, split)
                return [ts, wkv, cs], out + out2
            new, out = Mb.mamba_decode(p, state, x, split)
            return list(new), out

        if kind == "rwkv":
            dh = cfg.d_model // cfg.n_heads
            state = [torch.randn((2 * SB, cfg.d_model), generator=g),
                     torch.randn((2 * SB, cfg.n_heads, dh, dh), generator=g),
                     torch.randn((2 * SB, cfg.d_model), generator=g)]
            cdim = [None, 1, None]
        else:
            state = [torch.randn((2 * SB, cfg.ssm_conv - 1, cfg.d_inner), generator=g),
                     torch.randn((2 * SB, cfg.d_inner, cfg.ssm_state), generator=g)]
            cdim = [2, 1]
        xt = torch.randn((2 * SB, cfg.d_model), generator=g)

        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            xw = x.detach().requires_grad_(True)
            want = run(leaves, xw, False)
            want_g = torch.autograd.grad((want * c).sum(), [xw, *leaves.values()])
        want_state, want_step = step(p, xt, state, False)

        Sh.set_active_mesh(dm, dp_axes=("data",))
        tree = {kind: p}
        specs, _ = Sh.check_divisible(tree, Sh.param_pspecs(tree), dm)
        placed = Sh.place(tree, dm, Sh.named(dm, specs))[kind]
        split = Sh.channel_split(cfg.n_heads if kind == "rwkv" else cfg.d_inner)
        local = (Sh.rwkv_local if kind == "rwkv" else Sh.mamba_local)
        with torch.enable_grad():
            sl = {k: v.detach().requires_grad_(True) for k, v in placed.items()}
            xs = x.chunk(2)[dpi].detach().requires_grad_(True)
            got = run(local(Sh.localize(sl), split), xs, split)
            got_g = torch.autograd.grad((got * c.chunk(2)[dpi]).sum(), [xs, *sl.values()])
        rows = lambda t: t.chunk(2)[dpi]
        part = [rows(t) if d is None else Sh.chunk_of(rows(t), "model", d)
                for t, d in zip(state, cdim)]
        new, got_step = step(local(Sh.localize(placed), split), rows(xt), part, split)
        new = [t if d is None else Sh.all_gather(t, "model", d) for t, d in zip(new, cdim)]
        got_g = [Sh.all_gather(got_g[0], "data", 0)] + [t.full_tensor() for t in got_g[1:]]
        got = Sh.all_gather(got.detach(), "data", 0)
        got_step = Sh.all_gather(got_step, "data", 0)
        new = [Sh.all_gather(t, "data", 0) for t in new]
        Sh.clear_active_mesh()

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))

        return {"split": split, "seq_err": rel(got, want),
                "grad_err": max(rel(a, b) for a, b in zip(got_g, want_g)),
                "decode_err": max([rel(got_step, want_step)]
                                  + [rel(a, b) for a, b in zip(new, want_state)])}


    def rank_main(rank, port, tmp, archs):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import model as M, sharding as Sh
        from repro_torch.train import checkpoint as ckpt, optimizer as Opt, train_step as TS
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=4, rank=rank)
        res = {}
        try:
            lm = mesh_mod.make_test_mesh(4, 2)
            dm = mesh_mod.device_mesh(lm, "cpu")
            wide = mesh_mod.device_mesh(mesh_mod.make_test_mesh(4, 1), "cpu")
            for arch in archs + list(SERVE_ONLY):
                cfg = dataclasses.replace(configs.get(arch, reduced=True), dtype="float32")
                model = M.build(cfg)
                params = load_params(model, f"{tmp}/{arch}.params.npz")
                rng = np.random.default_rng(3)
                batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (SB, SS)))}
                if cfg.frontend == "vision":
                    batch["patches"] = torch.from_numpy(rng.standard_normal(
                        (SB, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
                if cfg.n_encoder_layers:
                    batch["frames"] = torch.from_numpy(rng.standard_normal(
                        (SB, cfg.encoder_tokens, cfg.d_model)).astype(np.float32))
                smodel = M.build(dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
                                 if cfg.n_experts else cfg)
                want = serve(M, smodel, params, batch)
                Sh.set_active_mesh(dm, dp_axes=("data",))
                specs, _ = Sh.check_divisible(params, Sh.param_pspecs(params), dm)
                pl = Sh.named(dm, specs)

                def put(t):
                    return Sh.place(t, dm, Sh.batch_placements(dm, t.shape[0], t.dim()))

                got = serve(M, smodel, Sh.place(params, dm, pl), batch, put, dm)
                Sh.clear_active_mesh()
                r = res[arch] = {}
                r["serve_err"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
                r["serve_tokens_equal"] = all(bool((a.argmax(-1) == b.argmax(-1)).all())
                                              for a, b in zip(got, want))
                if arch in SERVE_ONLY:
                    continue
                if cfg.family in ("ssm", "hybrid"):
                    r["block"] = recurrent_block(cfg, params, dm)

                z = np.load(f"{tmp}/{arch}.batches.npz")
                batches = [{k: torch.from_numpy(z[f"{s}|{k}"]) for k in ("tokens", "labels")}
                           for s in range(STEPS)]
                oc = Opt.OptConfig(lr=1e-3, total_steps=STEPS, warmup_steps=1)
                opt0 = Opt.adamw_init(params)
                step = TS.make_train_step(model, "adamw", oc, microbatches=MB, ce_chunk=16)
                p, o, losses = params, opt0, []
                for b in batches:
                    p, o, m = step(p, o, b)
                    losses.append(float(m["loss"]))
                r["unsharded_losses"] = losses
                Sh.set_active_mesh(dm, dp_axes=("data",))
                sstep = TS.make_train_step(
                    model, "adamw", oc, microbatches=MB, ce_chunk=16, grad_pspecs=pl,
                    batch_shardings=lambda nd: Sh.batch_placements(dm, B // MB, nd))
                sp = Sh.place(params, dm, pl)
                so = Sh.place(opt0, dm, TS.opt_state_placements("adamw", opt0, pl, dm))
                losses = []
                for b in batches:
                    sp, so, m = sstep(sp, so, {k: put(v) for k, v in b.items()})
                    losses.append(float(m["loss"]))
                r["sharded_losses"] = losses
                if not cfg.n_experts:  # one gradient, sharded against unsharded
                    with torch.enable_grad():
                        leaves = [t.detach().requires_grad_(True) for t in Opt.tree_leaves(params)]
                        want_g = torch.autograd.grad(M.forward_train(
                            model, Opt.tree_unflatten(params, leaves), batches[0], ce_chunk=16),
                            leaves, allow_unused=True)
                        sl = [t.detach().requires_grad_(True)
                              for t in Opt.tree_leaves(Sh.place(params, dm, pl))]
                        got_g = torch.autograd.grad(M.forward_train(
                            model, Opt.tree_unflatten(params, sl),
                            {k: put(v) for k, v in batches[0].items()}, ce_chunk=16),
                            sl, allow_unused=True)
                    r["grad_rel_err"] = max(
                        float((a.full_tensor() - b).abs().max() / b.abs().max().clamp_min(1e-12))
                        for a, b in zip(got_g, want_g) if b is not None)

                # checkpoint under (2 x 2); restore under (4 x 1) and unsharded
                state = {"params": sp, "opt": so}
                ckpt.save(f"{tmp}/{arch}.ckpt", STEPS, state)
                saved = Sh.full(state)
                Sh.set_active_mesh(wide, dp_axes=("data",))
                wspecs, _ = Sh.check_divisible(params, Sh.param_pspecs(params), wide)
                wpl = Sh.named(wide, wspecs)
                like = {"params": params, "opt": opt0}
                back, n = ckpt.restore(f"{tmp}/{arch}.ckpt", like,
                                       shardings={"params": wpl, "opt": TS.opt_state_placements(
                                           "adamw", opt0, wpl, wide)},
                                       mesh=wide)
                placed_ok = all(tuple(t.placements) == tuple(q) for t, q in zip(
                    Opt.tree_leaves(back["params"]), Opt.leaves_up_to(params, wpl)))
                full = Sh.full(back)
                Sh.clear_active_mesh()
                plain, _ = ckpt.restore(f"{tmp}/{arch}.ckpt", like)
                r["restore_step"] = n
                r["restored_placements"] = placed_ok
                r["restored_bitwise"] = all(torch.equal(a, b) for a, b in zip(
                    Opt.tree_leaves(full), Opt.tree_leaves(saved)))
                r["unsharded_bitwise"] = all(torch.equal(a, b) for a, b in zip(
                    Opt.tree_leaves(plain), Opt.tree_leaves(saved)))
            # microbatch rows over two DP axes (pod, data): the reference's rows
            pod = mesh_mod.device_mesh(mesh_mod.Mesh((2, 2, 1), ("pod", "data", "model")), "cpu")
            Sh.set_active_mesh(pod, dp_axes=("pod", "data"))
            s = Sh.dp_index()
            rows = torch.arange(2 * B).reshape(2 * B, 1) * 10
            local = rows.chunk(4)[s]
            got = {"split": Sh.microbatch_parts(local, True, True, MB),
                   "whole": Sh.microbatch_parts(local, True, False, MB),
                   "replicated": Sh.microbatch_parts(rows, False, True, MB)}
            mb = 2 * B // MB
            want = {"split": [rows[i * mb + s * mb // 4:i * mb + (s + 1) * mb // 4]
                              for i in range(MB)],
                    "whole": list(rows.split(mb))}
            want["replicated"] = want["split"]
            res["microbatch_rows"] = {}
            for k in got:   # every rank's parts
                ok = torch.tensor([int(len(got[k]) == MB and all(
                    torch.equal(a, b) for a, b in zip(got[k], want[k])))])
                dist.all_reduce(ok, op=dist.ReduceOp.MIN)
                res["microbatch_rows"][k] = bool(ok.item())
            Sh.clear_active_mesh()
            if rank == 0:
                json.dump(res, open(f"{tmp}/port.json", "w"))
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, int(sys.argv[1]), sys.argv[2],
                                                      sys.argv[3:]))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        sys.exit(1 if alive or any(p.exitcode for p in procs) else 0)
""") % dict(consts=repr((B, S, STEPS, MB, SB, SS, DECODE)), serve_only=repr(SERVE_ONLY))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_lm")
    for arch in ARCHS:
        batches = _batches(configs.get(arch, reduced=True))
        np.savez(tmp / f"{arch}.batches.npz",
                 **{f"{s}|{k}": v for s, b in enumerate(batches) for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for name, src in (("ref_init.py", _REF_INIT), ("ref_train.py", _REF_TRAIN),
                      ("port.py", _PORT)):
        (tmp / name).write_text(src)
    init = subprocess.run([sys.executable, str(tmp / "ref_init.py"), str(tmp), *ARCHS,
                           *SERVE_ONLY], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert init.returncode == 0, init.stderr[-3000:]
    ref = subprocess.Popen([sys.executable, str(tmp / "ref_train.py"), str(tmp), *ARCHS],
                           env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = subprocess.run([sys.executable, str(tmp / "port.py"), str(_free_port()), str(tmp),
                           *ARCHS], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=400)
    _, ref_err = ref.communicate(timeout=400)
    assert port.returncode == 0, port.stderr[-4000:]
    assert ref.returncode == 0, ref_err[-3000:]
    return (json.loads((tmp / "port.json").read_text()),
            json.loads((tmp / "ref_losses.json").read_text()))


@pytest.mark.parametrize("arch", ARCHS + SERVE_ONLY)
def test_sharded_serving_equals_unsharded(runs, arch):
    port, _ = runs
    assert port[arch]["serve_tokens_equal"]
    assert port[arch]["serve_err"] <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_the_reference_sharded_step(runs, arch):
    port, ref = runs
    np.testing.assert_allclose(port[arch]["sharded_losses"], ref[arch], rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_train_equals_unsharded(runs, arch):
    port, _ = runs
    np.testing.assert_allclose(port[arch]["sharded_losses"], port[arch]["unsharded_losses"],
                               rtol=1e-5, atol=0)
    assert all(np.isfinite(port[arch]["sharded_losses"]))


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_gradient_equals_unsharded(runs, arch):
    """Every parameter's gradient of one loss, gathered from its shards,
    against the unsharded gradient (relative to the leaf's largest entry):
    the losses alone would not show a gradient scaled by a constant, which
    Adam's update ignores."""
    port, _ = runs
    assert port[arch]["grad_rel_err"] <= 1e-5


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_recurrent_block_split_equals_unsharded(runs, arch):
    """rwkv's heads and mamba's channels split over 'model' at unit-scale
    inputs: output, every gradient and one decode step (output and states)
    within 1e-5 of each tensor's largest entry of the whole block."""
    b = runs[0][arch]["block"]
    assert b["split"]
    assert b["seq_err"] <= 1e-5 and b["grad_err"] <= 1e-5 and b["decode_err"] <= 1e-5


@pytest.mark.parametrize("case", ["split", "whole", "replicated"])
def test_microbatch_rows_are_the_references(runs, case):
    """On a (pod 2, data 2) DP grid, each rank's part of microbatch i is
    its share of rows i*mb .. of the global batch (or all of them), from a
    batch split over both DP axes or replicated."""
    assert runs[0]["microbatch_rows"][case]


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_elastically(runs, arch):
    port, _ = runs
    r = port[arch]
    assert r["restore_step"] == STEPS
    assert r["restored_placements"] and r["restored_bitwise"] and r["unsharded_bitwise"]
