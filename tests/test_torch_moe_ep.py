"""``moe_ffn_ep`` on four gloo ranks (a 2 x 2 data x model mesh) against the
JAX package's shard_map schedule under ``make_test_mesh(4, 2)``.

The weights and tokens are made here from a seed with NumPy.  The reference
runs in a subprocess with four XLA CPU devices (bf16 op by op under
``jax.disable_jit()``: XLA's fusions skip the roundings to bf16 between
ops that eager PyTorch makes, see PERF.md); the port runs as four
spawned ranks, each holding its DP row of the tokens and its shards of the
weights (placed by the specs of ``models.sharding``), and rank 0 gathers the
rows.  The tokens share an offset that the router's first column picks up,
so every token routes to expert 0 and a DP row's capacity overflows (the
test checks that pairs were dropped).  The two
fallbacks of the reference's rule (E % n_model, T % dp_size) must equal the
port's ``moe_ffn`` on the global tokens.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 64
# (arch, dtype): dbrx (no shared expert) and kimi (one shared expert)
CASES = [(a, dt) for a in ("dbrx-132b", "kimi-k2-1t-a32b") for dt in ("float32", "bfloat16")]
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _case_name(arch, dt):
    return f"{arch}-{dt}"


def _weights(rng, d, f, E, n_shared):
    def w(*shape, scale=None):
        s = scale if scale is not None else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * s).astype(np.float32)

    router = w(d, E)
    router[:, 0] += 0.5  # with the tokens' +0.5 offset: expert 0 in every top-k
    p = {"router": router, "w_gate": w(E, d, f), "w_up": w(E, d, f),
         "w_down": w(E, f, d, scale=f**-0.5)}
    if n_shared:
        p["shared/w_gate"] = w(d, n_shared * f)
        p["shared/w_up"] = w(d, n_shared * f)
        p["shared/w_down"] = w(n_shared * f, d, scale=f**-0.5)
    return p


def _inputs(path):
    rng = np.random.default_rng(7)
    arrays, meta = {}, {}
    for arch, dt in CASES:
        cfg = configs.get(arch, reduced=True)
        name = _case_name(arch, dt)
        for k, v in _weights(rng, cfg.d_model, cfg.d_ff, cfg.n_experts,
                             cfg.n_shared_experts).items():
            arrays[f"{name}|{k}"] = v
        arrays[f"{name}|x"] = (rng.standard_normal((T, cfg.d_model)) + 0.5).astype(np.float32)
        meta[name] = dict(top_k=cfg.moe_top_k, cf=cfg.capacity_factor, dtype=dt)
    # the fallbacks: 3 experts (E % 2 != 0), and 63 tokens (T % 2 != 0)
    cfg = configs.get("dbrx-132b", reduced=True)
    for name, E, t in (("fallback-experts", 3, T), ("fallback-tokens", cfg.n_experts, T - 1)):
        for k, v in _weights(rng, cfg.d_model, cfg.d_ff, E, 0).items():
            arrays[f"{name}|{k}"] = v
        arrays[f"{name}|x"] = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
        meta[name] = dict(top_k=cfg.moe_top_k, cf=cfg.capacity_factor, dtype="float32")
    np.savez(path, **arrays)
    return meta


_REF = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.launch import mesh as mesh_mod
    from repro.models import moe, sharding as Sh
    z = np.load(sys.argv[1]); meta = json.loads(sys.argv[2])
    mesh = mesh_mod.make_test_mesh(4, 2)
    Sh.set_active_mesh(mesh, dp_axes=("data",))
    out = {}
    for name, m in meta.items():
        if name.startswith("fallback"):
            continue
        dt = jnp.bfloat16 if m["dtype"] == "bfloat16" else jnp.float32
        p = {}
        for k in z.files:
            if k.startswith(name + "|") and not k.endswith("|x"):
                parts = k[len(name) + 1:].split("/")
                v = jnp.asarray(z[k], jnp.float32 if parts[-1] == "router" else dt)
                (p.setdefault(parts[0], {}) if len(parts) == 2 else p)[parts[-1]] = v
        x = jnp.asarray(z[name + "|x"], dt)
        if m["dtype"] == "bfloat16":   # op by op: every op's output rounded, as eager
            with jax.disable_jit():
                o, aux = moe.moe_ffn_ep(p, x, m["top_k"], m["cf"])
        else:
            o, aux = jax.jit(lambda p, x: moe.moe_ffn_ep(p, x, m["top_k"], m["cf"]))(p, x)
        out[name + "|out"] = np.asarray(o.astype(jnp.float32))
        out[name + "|aux"] = np.asarray(aux, np.float32)
    np.savez(sys.argv[3], **out)
""")

_PORT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, port, data, meta, out):
        torch.set_num_threads(1)
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import moe, sharding as Sh
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=4, rank=rank)
        try:
            lm = mesh_mod.make_test_mesh(4, 2)
            dm = mesh_mod.device_mesh(lm, "cpu")
            Sh.set_active_mesh(dm, dp_axes=("data",))
            z = np.load(data)
            res = {}
            for name, m in json.loads(meta).items():
                dt = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
                p = {}
                for k in z.files:
                    if k.startswith(name + "|") and not k.endswith("|x"):
                        parts = k[len(name) + 1:].split("/")
                        v = torch.from_numpy(z[k]).to(torch.float32 if parts[-1] == "router"
                                                      else dt)
                        (p.setdefault(parts[0], {}) if len(parts) == 2 else p)[parts[-1]] = v
                tree = {"moe": p}
                specs, _ = Sh.check_divisible(tree, Sh.param_pspecs(tree), dm)
                placed = Sh.place(tree, dm, Sh.named(dm, specs))["moe"]
                x = torch.from_numpy(z[name + "|x"]).to(dt)
                split = x.shape[0] % 2 == 0
                mine = x.chunk(2)[dm.get_local_rank("data")] if split else x
                with torch.no_grad():
                    o, aux = moe.moe_ffn_ep(placed, mine, m["top_k"], m["cf"], dp_split=split)
                    full = Sh.all_gather(o, "data", 0) if split else o
                    res[name + "|out"] = full.float().numpy()
                    res[name + "|aux"] = np.asarray(float(aux), np.float32)
                    if name.startswith("fallback"):
                        Sh.clear_active_mesh()
                        o2, aux2 = moe.moe_ffn(p, x, m["top_k"], m["cf"])
                        Sh.set_active_mesh(dm, dp_axes=("data",))
                        res[name + "|plain_out"] = o2.float().numpy()
                        res[name + "|plain_aux"] = np.asarray(float(aux2), np.float32)
                    else:
                        # pairs past the per-row capacity, as the EP path counts them
                        probs = torch.softmax(mine.float() @ p["router"], dim=-1)
                        se = moe._top_k(probs, m["top_k"])[1].reshape(-1)
                        E = p["router"].shape[1]
                        onehot = torch.nn.functional.one_hot(se, E)
                        pos = ((onehot.cumsum(0) - 1) * onehot).sum(1)
                        C = max(1, int(mine.shape[0] * m["top_k"] / E * m["cf"]))
                        res[name + "|dropped"] = np.asarray(int((pos >= C).sum()))
            if rank == 0:
                np.savez(out, **res)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, int(sys.argv[1]), sys.argv[2],
                                                      sys.argv[3], sys.argv[4]))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(240)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        sys.exit(1 if alive or any(p.exitcode for p in procs) else 0)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    data = str(tmp / "in.npz")
    meta = json.dumps(_inputs(data))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    (tmp / "ref.py").write_text(_REF)
    (tmp / "port.py").write_text(_PORT)
    ref = subprocess.Popen([sys.executable, str(tmp / "ref.py"), data, meta, str(tmp / "ref.npz")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    port = subprocess.run([sys.executable, str(tmp / "port.py"), str(_free_port()), data, meta,
                           str(tmp / "port.npz")], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    _, ref_err = ref.communicate(timeout=300)
    assert ref.returncode == 0, ref_err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    return np.load(tmp / "ref.npz"), np.load(tmp / "port.npz")


@pytest.mark.parametrize("arch,dtype", CASES)
def test_ep_matches_the_reference_shard_map(runs, arch, dtype):
    ref, port = runs
    name = _case_name(arch, dtype)
    got, want = port[name + "|out"], ref[name + "|out"]
    assert got.shape == want.shape == (T, configs.get(arch, reduced=True).d_model)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_allclose(port[name + "|aux"], ref[name + "|aux"], **TOL[dtype])


@pytest.mark.parametrize("arch,dtype", CASES)
def test_the_per_row_capacity_overflows(runs, arch, dtype):
    """The tokens overflow a DP row's capacity, so the trash column is used."""
    _, port = runs
    assert int(port[_case_name(arch, dtype) + "|dropped"]) > 0


@pytest.mark.parametrize("case", ["fallback-experts", "fallback-tokens"])
def test_fallbacks_equal_moe_ffn(runs, case):
    """E % n_model != 0 (3 experts on 2 model ranks) and T % dp != 0 (63
    tokens on 2 DP rows) run ``moe_ffn`` over the global tokens."""
    _, port = runs
    np.testing.assert_array_equal(port[case + "|out"], port[case + "|plain_out"])
    np.testing.assert_array_equal(port[case + "|aux"], port[case + "|plain_aux"])
    assert torch.isfinite(torch.from_numpy(port[case + "|out"])).all()
