"""The sharded train step's other optimizer paths on four gloo ranks (a 2 x 2
data x model mesh): int8 gradient compression (``compress_grads=True``, with
AdamW) and adamw8, whose blockwise state is replicated (the reference's
``P()``), for the reduced TinyLlama (dense placements) and dbrx (EP's
expert-sharded leaves) in fp32.

Each runs 3 steps of 2 microbatches beside the JAX package's sharded step
on ``make_test_mesh(4, 2)`` in a subprocess with four XLA CPU devices, on
the same weights and batches; TinyLlama also beside the unsharded port.
Held: the losses (rtol 1e-5); the parameters gathered after steps 1 and 3
against the reference's and the unsharded port's (the bars below); adamw8's
codes equal on every rank and, against the unsharded port's, the
first moment's equal but for at most 0.1 % off by one and the second
moment's differing in no larger a share, nor by more, than the
reference's own sharded and unsharded steps differ; on one seeded
gradient the sharded update and compression give the unsharded bits;
every gradient reaches the optimizer placed like its parameter; an adamw8
state saved under (2 x 2) restores bitwise under (4 x 1) and unsharded
through ``train_step.opt_state_placements``.

dbrx: under EP a DP row's tokens have their own capacity (the reference's
``moe_ffn_ep``), so its sharded step is held to the reference's only.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import configs
from repro_torch.train import data as D
from repro_torch.train import optimizer as Opt
from repro_torch.train import train_step as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("tinyllama-1.1b", "dbrx-132b")
# case -> (optimizer, compress_grads)
CASES = {"compress": ("adamw", True), "adamw8": ("adamw8", False)}
B, S, STEPS, MB = 8, 32, 3, 2        # 8 x 32 tokens, 3 steps of 2 microbatches
KEPT = (1, 3)                        # the steps after which parameters are compared
LR = 1e-3
# Runs whose gradients sum in another order (sharded against unsharded, or
# against the reference's GSPMD partition) differ in the last bits of each
# gradient and more, relatively, where a gradient nearly cancels.  adamw8's
# second-moment codes are log-space over each block's range, so such an
# entry can move its code, or the block's minimum and with it every code of
# the block: the reference's own sharded (2 x 2) and unsharded adamw8
# steps on these batches differ in 0.29 % of the second-moment codes after
# step 1 and 1.1 % after step 3, by up to 4 (the reference run here
# measures it).  So the first-moment codes are held to test_torch_train.py's
# bar (equal but for 0.1 % off by one), the second-moment codes to the reference's
# own spread, and the parameters, which follow the codes, loosely: every
# entry within 4 lr a step of the other run's (Adam moves an entry by about
# lr a step), all but 0.1 % (adamw8: 1 %) within 1e-5 of their leaf's
# largest entry (test_sharded_train_*'s rtol).  One shared gradient gives
# the unsharded update's bits exactly: the sharp check of the mechanism.
BULK = {"compress": 1e-3, "adamw8": 1e-2}

def _batches(cfg):
    dcfg = D.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    out = [D.batch_for_step(dcfg, s) for s in range(STEPS)]
    for b in out:  # microbatches count different numbers of labels
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

_REF = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import mesh as mesh_mod
    from repro.models import model as Mod, sharding as Sh
    from repro.train import optimizer as Opt, train_step as TS
    tmp = sys.argv[1]
    cases = json.loads(sys.argv[2])
    mesh = mesh_mod.make_test_mesh(4, 2)
    Sh.set_active_mesh(mesh, dp_axes=("data",))
    dp = ("data",)
    out, kept = {}, {}
    for arch in sys.argv[3:]:
        cfg = dataclasses.replace(configs.get(arch, reduced=True), dtype="float32")
        model = Mod.build(cfg)
        params0 = Mod.init_params(model, jax.random.key(0))
        pspecs, _ = Sh.check_divisible(params0, Sh.param_pspecs(params0), mesh)
        psh = Sh.named(mesh, pspecs)
        z = np.load(f"{tmp}/{arch}.batches.npz")
        for case, (opt_name, compress) in cases.items():
            opt_init, _ = Opt.OPTIMIZERS[opt_name]
            opt = opt_init(params0)
            rep = NamedSharding(mesh, P())
            osh = ({"m": psh, "v": psh, "step": rep} if opt_name == "adamw"
                   else jax.tree.map(lambda leaf: rep, opt))
            bsh = NamedSharding(mesh, P(dp, None))
            oc = Opt.OptConfig(lr=%(lr)r, total_steps=%(steps)d, warmup_steps=1)
            step = TS.make_train_step(
                model, opt_name, oc, microbatches=%(mb)d, ce_chunk=16, compress_grads=compress,
                grad_pspecs=psh,
                batch_shardings=lambda nd: NamedSharding(mesh, P(None, dp, *([None] * (nd - 2)))))
            jitted = jax.jit(step, in_shardings=(psh, osh, {"tokens": bsh, "labels": bsh}),
                             out_shardings=(psh, osh, None))
            params, opt = jax.device_put(params0, psh), jax.device_put(opt, osh)
            losses, states = [], {}
            for s in range(%(steps)d):
                b = {k: jnp.asarray(z[f"{s}|{k}"]) for k in ("tokens", "labels")}
                params, opt, m = jitted(params, opt, b)
                losses.append(float(m["loss"]))
                if s + 1 in %(kept)r:
                    states[s + 1] = jax.tree.map(np.asarray, opt)
                    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
                        kept[f"{arch}|{case}|{s + 1}|reference|{Sh._path_str(p)}"] = np.asarray(v)
            out[f"{arch}|{case}"] = losses
            if opt_name == "adamw8" and not cfg.n_experts:
                # the reference's own adamw8 codes, sharded against unsharded
                Sh.clear_active_mesh()
                plain = jax.jit(TS.make_train_step(model, opt_name, oc, microbatches=%(mb)d,
                                                   ce_chunk=16))
                params, opt = params0, opt_init(params0)
                for s in range(%(steps)d):
                    b = {k: jnp.asarray(z[f"{s}|{k}"]) for k in ("tokens", "labels")}
                    params, opt, _ = plain(params, opt, b)
                    if s + 1 in %(kept)r:
                        for k in "mv":
                            pairs = [(x.astype(np.int32), y.astype(np.int32)) for x, y in zip(
                                jax.tree.leaves(states[s + 1][k]), jax.tree.leaves(opt[k]))
                                if x.dtype == np.int8]
                            out[f"{arch}|{case}|codes_off_{s + 1}|{k}"] = [
                                max(int(np.abs(x - y).max()) for x, y in pairs),
                                sum(int((x != y).sum()) for x, y in pairs)
                                / sum(x.size for x, _ in pairs)]
                Sh.set_active_mesh(mesh, dp_axes=("data",))
    json.dump(out, open(f"{tmp}/ref_losses.json", "w"))
    np.savez(f"{tmp}/ref_params.npz", **kept)
""") % dict(lr=LR, steps=STEPS, mb=MB, kept=KEPT)

_PORT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    B, STEPS, MB, KEPT, LR = %(consts)s


    def load_params(model, path):
        from repro_torch.models import model as M, sharding as Sh
        z = np.load(path)
        like = M.params_specs(model)
        return Sh.tree_map_with_path(
            lambda p, leaf: torch.from_numpy(z[Sh._path_str(p)]).to(leaf.dtype), like)


    def flat_named(tree):
        from repro_torch.models import sharding as Sh
        out = {}
        Sh.tree_map_with_path(lambda p, leaf: out.__setitem__(Sh._path_str(p), leaf), tree)
        return out


    def same_on_every_rank(tensors):
        # the largest and smallest of each entry over the ranks are equal
        ok = True
        for t in tensors:
            t = t.double()
            hi, lo = t.clone(), t.clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX)
            dist.all_reduce(lo, op=dist.ReduceOp.MIN)
            ok = ok and bool(torch.equal(hi, lo))
        return ok


    def codes_off(got, want):
        # (largest code difference, share of codes off) over the int8 leaves
        diffs = [(a.int() - b.int()).abs() for a, b in zip(got, want) if a.dtype == torch.int8]
        return (max(int(d.max()) for d in diffs),
                sum(int((d > 0).sum()) for d in diffs) / sum(d.numel() for d in diffs))


    def one_gradient(params, dm):
        # adamw8's update (two steps) and the int8 compression on one seeded
        # gradient, sharded against unsharded; no clipping (its norm sums in
        # another order over the ranks)
        from repro_torch.models import model as M, sharding as Sh
        from repro_torch.train import optimizer as Opt, train_step as TS
        g = torch.Generator().manual_seed(11)
        grads = M.tree_map(lambda t: 1e-2 * torch.randn(t.shape, generator=g), params)
        oc = Opt.OptConfig(lr=LR, total_steps=STEPS, warmup_steps=1, grad_clip=1e9)
        s0 = Opt.adamw8_init(params)
        p, o = params, s0
        for _ in range(2):
            p, o, _ = Opt.adamw8_update(p, grads, o, oc)
        Sh.set_active_mesh(dm, dp_axes=("data",))
        specs, _ = Sh.check_divisible(params, Sh.param_pspecs(params), dm)
        pl = Sh.named(dm, specs)
        sp, sg = Sh.place(params, dm, pl), Sh.place(grads, dm, pl)
        so = Sh.place(s0, dm, TS.opt_state_placements("adamw8", s0, pl, dm))
        for _ in range(2):
            sp, so, _ = TS._sharded_update("adamw8", Opt.adamw8_update, sp, sg, so, oc)
        out = {"adamw8": all(torch.equal(a, b) for a, b in zip(
                   Opt.tree_leaves(Sh.full({"p": sp, "o": so})),
                   Opt.tree_leaves({"p": p, "o": o}))),
               "compress": all(torch.equal(a, b) for a, b in zip(
                   Opt.tree_leaves(Sh.full(TS._compress_grads_int8(sg))),
                   Opt.tree_leaves(TS._compress_grads_int8(grads))))}
        Sh.clear_active_mesh()
        return out


    def rank_main(rank, port, tmp, cases, archs):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import model as M, sharding as Sh
        from repro_torch.train import checkpoint as ckpt, optimizer as Opt, train_step as TS
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=4, rank=rank)
        res, kept = {}, {}
        seen = []
        update = TS._sharded_update

        def spy(opt_name, opt_update, params, grads, *rest):
            seen.append(all(tuple(g.placements) == tuple(p.placements) for p, g in zip(
                Opt.tree_leaves(params), Opt.leaves_up_to(params, grads))))
            return update(opt_name, opt_update, params, grads, *rest)

        TS._sharded_update = spy
        try:
            dm = mesh_mod.device_mesh(mesh_mod.make_test_mesh(4, 2), "cpu")
            wide = mesh_mod.device_mesh(mesh_mod.make_test_mesh(4, 1), "cpu")
            for arch in archs:
                cfg = dataclasses.replace(configs.get(arch, reduced=True), dtype="float32")
                model = M.build(cfg)
                params = load_params(model, f"{tmp}/{arch}.params.npz")
                z = np.load(f"{tmp}/{arch}.batches.npz")
                batches = [{k: torch.from_numpy(z[f"{s}|{k}"]) for k in ("tokens", "labels")}
                           for s in range(STEPS)]
                oc = Opt.OptConfig(lr=LR, total_steps=STEPS, warmup_steps=1)
                for case, (opt_name, compress) in cases.items():
                    r = res[f"{arch}|{case}"] = {}
                    opt0 = Opt.OPTIMIZERS[opt_name][0](params)
                    unsharded = {}
                    if not cfg.n_experts:
                        step = TS.make_train_step(model, opt_name, oc, microbatches=MB,
                                                  ce_chunk=16, compress_grads=compress)
                        p, o, losses = params, opt0, []
                        for s, b in enumerate(batches):
                            p, o, m = step(p, o, b)
                            losses.append(float(m["loss"]))
                            if s + 1 in KEPT:
                                unsharded[s + 1] = (p, o)
                                if rank == 0:
                                    for k, v in flat_named(p).items():
                                        kept[f"{arch}|{case}|{s + 1}|unsharded|{k}"] = v.numpy()
                        r["unsharded_losses"] = losses
                    Sh.set_active_mesh(dm, dp_axes=("data",))
                    specs, _ = Sh.check_divisible(params, Sh.param_pspecs(params), dm)
                    pl = Sh.named(dm, specs)

                    def put(t):
                        return Sh.place(t, dm, Sh.batch_placements(dm, t.shape[0], t.dim()))

                    sstep = TS.make_train_step(
                        model, opt_name, oc, microbatches=MB, ce_chunk=16,
                        compress_grads=compress, grad_pspecs=pl,
                        batch_shardings=lambda nd: Sh.batch_placements(dm, B // MB, nd))
                    sp = Sh.place(params, dm, pl)
                    so = Sh.place(opt0, dm, TS.opt_state_placements(opt_name, opt0, pl, dm))
                    r["state_replicated"] = all(
                        all(q.is_replicate() for q in t.placements)
                        for t in Opt.tree_leaves({"m": so["m"], "v": so["v"]})
                    ) if opt_name == "adamw8" else None
                    losses, seen[:] = [], []
                    for s, b in enumerate(batches):
                        sp, so, m = sstep(sp, so, {k: put(v) for k, v in b.items()})
                        losses.append(float(m["loss"]))
                        if s + 1 not in KEPT:
                            continue
                        full = Sh.full(sp)
                        if rank == 0:
                            for k, v in flat_named(full).items():
                                kept[f"{arch}|{case}|{s + 1}|sharded|{k}"] = v.numpy()
                        if opt_name != "adamw8":
                            continue
                        state = [t.to_local() for t in Opt.tree_leaves(
                            {"m": so["m"], "v": so["v"]})]
                        r[f"state_same_on_every_rank_{s + 1}"] = same_on_every_rank(state)
                        if s + 1 in unsharded:
                            r[f"codes_off_{s + 1}"] = {k: codes_off(
                                [t.to_local() for t in Opt.tree_leaves(so[k])],
                                Opt.tree_leaves(unsharded[s + 1][1][k])) for k in "mv"}
                    r["sharded_losses"] = losses
                    r["grads_placed_like_params"] = len(seen) == STEPS and all(seen)
                    if opt_name == "adamw8":
                        # saved under (2 x 2); restored under (4 x 1) and unsharded
                        state = {"params": sp, "opt": so}
                        ckpt.save(f"{tmp}/{arch}.ckpt", STEPS, state)
                        saved = Sh.full(state)
                        Sh.set_active_mesh(wide, dp_axes=("data",))
                        wspecs, _ = Sh.check_divisible(params, Sh.param_pspecs(params), wide)
                        wpl = Sh.named(wide, wspecs)
                        like = {"params": params, "opt": opt0}
                        back, n = ckpt.restore(
                            f"{tmp}/{arch}.ckpt", like, mesh=wide, shardings={
                                "params": wpl,
                                "opt": TS.opt_state_placements(opt_name, opt0, wpl, wide)})
                        r["restored_state_replicated"] = all(
                            all(q.is_replicate() for q in t.placements)
                            for t in Opt.tree_leaves({k: back["opt"][k] for k in "mv"}))
                        full = Sh.full(back)
                        Sh.clear_active_mesh()
                        plain, _ = ckpt.restore(f"{tmp}/{arch}.ckpt", like)
                        r["restore_step"] = n
                        r["restored_bitwise"] = all(torch.equal(a, b) for a, b in zip(
                            Opt.tree_leaves(full), Opt.tree_leaves(saved)))
                        r["unsharded_bitwise"] = all(torch.equal(a, b) for a, b in zip(
                            Opt.tree_leaves(plain), Opt.tree_leaves(saved)))
                    Sh.clear_active_mesh()
                res[f"{arch}|one_gradient"] = one_gradient(params, dm)
            # full and shard_like against place, where two mesh axes split one dim
            pod = mesh_mod.device_mesh(mesh_mod.Mesh((2, 2, 1), ("pod", "data", "model")), "cpu")
            t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
            ok = True
            for spec in ((("pod", "data"), None, None), ("data", "pod", None), (None, None, None)):
                placed = Sh.place(t, pod, Sh.placements_of(pod, spec))
                back = Sh.full(placed)
                again = Sh.shard_like(back, placed)
                ok = ok and torch.equal(back, t) and torch.equal(again.to_local(),
                                                                 placed.to_local())
            res["full_inverts_place"] = ok
            if rank == 0:
                json.dump(res, open(f"{tmp}/port.json", "w"))
                np.savez(f"{tmp}/port_params.npz", **kept)
        finally:
            TS._sharded_update = update
            dist.destroy_process_group()


    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        cases = json.loads(sys.argv[3])
        procs = [ctx.Process(target=rank_main, args=(r, int(sys.argv[1]), sys.argv[2], cases,
                                                      sys.argv[4:]))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        sys.exit(1 if alive or any(p.exitcode for p in procs) else 0)
""") % dict(consts=repr((B, STEPS, MB, KEPT, LR)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_opt")
    for arch in ARCHS:
        batches = _batches(configs.get(arch, reduced=True))
        np.savez(tmp / f"{arch}.batches.npz",
                 **{f"{s}|{k}": v for s, b in enumerate(batches) for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for name, src in (("ref_init.py", _REF_INIT), ("ref.py", _REF), ("port.py", _PORT)):
        (tmp / name).write_text(src)
    init = subprocess.run([sys.executable, str(tmp / "ref_init.py"), str(tmp), *ARCHS], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert init.returncode == 0, init.stderr[-3000:]
    cases = json.dumps(CASES)
    ref = subprocess.Popen([sys.executable, str(tmp / "ref.py"), str(tmp), cases, *ARCHS],
                           env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = subprocess.run([sys.executable, str(tmp / "port.py"), str(_free_port()), str(tmp),
                           cases, *ARCHS], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=400)
    _, ref_err = ref.communicate(timeout=400)
    assert port.returncode == 0, port.stderr[-4000:]
    assert ref.returncode == 0, ref_err[-3000:]
    with np.load(tmp / "ref_params.npz") as r, np.load(tmp / "port_params.npz") as p:
        params = {**{k: r[k] for k in r.files}, **{k: p[k] for k in p.files}}
    return (json.loads((tmp / "port.json").read_text()),
            json.loads((tmp / "ref_losses.json").read_text()), params)


def _params(params, arch, case, step, run) -> dict:
    head = f"{arch}|{case}|{step}|{run}|"
    return {k[len(head):]: v for k, v in params.items() if k.startswith(head)}


def _assert_params_close(got: dict, want: dict, bulk: float, tag: str):
    """Every entry within 4 lr a step of the other run's; all but ``bulk``
    of the entries within 1e-5 of their leaf's largest entry."""
    assert got.keys() == want.keys() and got, tag
    off = total = 0
    for k in want:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        d = np.abs(a - b)
        assert d.max() <= 4 * LR * STEPS, f"{tag} {k}: {d.max()}"
        off += int((d > 1e-5 * np.abs(b).max()).sum())
        total += d.size
    assert off <= bulk * total, f"{tag}: {off} of {total} entries off"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference_sharded_step(runs, arch, case):
    port, ref, _ = runs
    np.testing.assert_allclose(port[f"{arch}|{case}"]["sharded_losses"], ref[f"{arch}|{case}"],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("step", KEPT)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_params_match_the_reference_sharded_step(runs, arch, case, step):
    _, _, params = runs
    _assert_params_close(_params(params, arch, case, step, "sharded"),
                         _params(params, arch, case, step, "reference"), BULK[case],
                         f"{arch} {case} {step}")


@pytest.mark.parametrize("step", KEPT)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_unsharded(runs, case, step):
    port, _, params = runs
    r = port[f"tinyllama-1.1b|{case}"]
    np.testing.assert_allclose(r["sharded_losses"], r["unsharded_losses"], rtol=1e-5, atol=0)
    _assert_params_close(_params(params, "tinyllama-1.1b", case, step, "sharded"),
                         _params(params, "tinyllama-1.1b", case, step, "unsharded"),
                         BULK[case], f"{case} {step}")


@pytest.mark.parametrize("step", KEPT)
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw8_state_is_replicated_and_equal_on_every_rank(runs, arch, step):
    r = runs[0][f"{arch}|adamw8"]
    assert r["state_replicated"]
    assert r[f"state_same_on_every_rank_{step}"]


@pytest.mark.parametrize("step", KEPT)
def test_adamw8_codes_match_the_unsharded_steps(runs, step):
    """First-moment codes equal but for at most 0.1 % off by one; the
    second-moment codes off in no larger a share, and by no more, than the
    reference's own sharded and unsharded codes (see BULK)."""
    r = runs[0]["tinyllama-1.1b|adamw8"][f"codes_off_{step}"]
    ref_worst, ref_share = runs[1][f"tinyllama-1.1b|adamw8|codes_off_{step}|v"]
    worst, share = r["m"]
    assert worst <= 1 and share <= 1e-3, r
    assert r["v"][0] <= ref_worst and r["v"][1] <= ref_share, (r, ref_worst, ref_share)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_gradient_gives_the_unsharded_bits(runs, arch, case):
    """adamw8's update over two steps (parameters, codes, scales) and the
    int8 compression, on one seeded gradient placed like the parameters,
    gathered equal bit for bit to the unsharded ones."""
    assert runs[0][f"{arch}|one_gradient"][case]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_reach_the_optimizer_placed_like_their_parameters(runs, arch, case):
    assert runs[0][f"{arch}|{case}"]["grads_placed_like_params"]


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw8_checkpoint_restores_elastically(runs, arch):
    r = runs[0][f"{arch}|adamw8"]
    assert r["restore_step"] == STEPS
    assert r["restored_state_replicated"] and r["restored_bitwise"] and r["unsharded_bitwise"]


def test_opt_state_placements():
    """AdamW's moments take their parameters' placements and ``step`` none;
    every adamw8 leaf is replicated over every mesh dim."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((2, 2)))
    params = {"w": torch.zeros(4, 512), "b": (torch.zeros(3),)}
    pl = {"w": (Shard(0), Shard(1)), "b": ((Replicate(), Replicate()),)}
    assert TS.opt_state_placements("adamw", Opt.adamw_init(params), pl, mesh) == {
        "m": pl, "v": pl, "step": None}
    got = TS.opt_state_placements("adamw8", Opt.adamw8_init(params), pl, mesh)
    rep = (Replicate(), Replicate())
    assert got == {"m": {"w": {"q": rep, "s": rep}, "b": ({"q": rep, "s": rep},)},
                   "v": {"w": {"q": rep, "s": rep, "mn": rep},
                         "b": ({"q": rep, "s": rep, "mn": rep},)},
                   "step": None}


def test_sharded_update_refuses_a_gradient_placed_unlike_its_parameter():
    """A replicated gradient beside a sharded parameter would hand the
    optimizer a full tensor beside a shard."""
    p = types.SimpleNamespace(placements=(Shard(0), Replicate()))
    g = types.SimpleNamespace(placements=(Replicate(), Replicate()))
    with pytest.raises(ValueError, match="placed"):
        TS._sharded_update("adamw", None, {"w": p}, {"w": g}, {}, None)


def test_full_and_shard_like_invert_place(runs):
    """On a (pod 2, data 2, model 1) mesh, a tensor placed with both DP axes
    on one dim, or each on its own: ``Sh.full`` gathers the placed tensor
    back whole, and ``Sh.shard_like`` slices it back to each rank's shard."""
    assert runs[0]["full_inverts_place"]
