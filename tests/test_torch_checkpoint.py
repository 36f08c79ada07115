"""The port's checkpointing and data pipeline (repro_torch.train.checkpoint,
repro_torch.train.data) and its fault tolerance (launch.train --resume,
launch.elastic), on the CPU.

The ports of tests/test_checkpoint.py come first; then the JAX package's
own functions on the same inputs: ``batch_for_step`` must give identical
arrays, and a checkpoint written by either package must restore in the
other with every leaf equal bit for bit (bfloat16 included) and the same
manifest.  Resuming after an injected failure must give, bit for bit, the
losses and the final checkpoint of an uninterrupted run.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import elastic
from repro_torch.launch import train as train_cli
from repro_torch.models import model as PM
from repro_torch.train import checkpoint as Ckpt
from repro_torch.train import data as Data
from repro_torch.train import optimizer as Opt

try:  # the reference: on the CPU host; the card's host has no JAX
    import jax
    import jax.numpy as jnp

    from repro.train import checkpoint as RCkpt
    from repro.train import data as RData
except ImportError:
    jax = None
needs_reference = pytest.mark.skipif(jax is None, reason="needs the JAX package")

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn((8, 16), generator=g),
            "b16": torch.randn((4, 4), generator=g).to(torch.bfloat16),
            "nested": ({"a": torch.arange(5, dtype=torch.int32)},),
        },
        "opt": {"m": torch.zeros((8, 16)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------ ports of tests/test_checkpoint.py


def test_roundtrip(tmp_path):
    st = _state()
    Ckpt.save(str(tmp_path), 3, st)
    like = PM.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), st)
    restored, step = Ckpt.restore(str(tmp_path), like)
    assert step == 3
    assert all(_equal(a, b) for a, b in zip(Opt.tree_leaves(st), Opt.tree_leaves(restored)))
    assert isinstance(restored["params"]["nested"], tuple)


def test_latest_pointer_advances(tmp_path):
    st = _state()
    Ckpt.save(str(tmp_path), 1, st)
    Ckpt.save(str(tmp_path), 5, st)
    assert Ckpt.latest_step(str(tmp_path)) == 5


def test_no_partial_checkpoint_on_failure(tmp_path, monkeypatch):
    """A save interrupted before rename must leave LATEST intact."""
    st = _state()
    Ckpt.save(str(tmp_path), 1, st)

    class Boom(RuntimeError):
        pass

    def bomb(*a, **kw):
        raise Boom()

    monkeypatch.setattr(np, "savez", bomb)
    with pytest.raises(Boom):
        Ckpt.save(str(tmp_path), 2, st)
    monkeypatch.undo()
    assert Ckpt.latest_step(str(tmp_path)) == 1
    # no stray temp dirs
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]


def test_data_replay_deterministic():
    cfg = Data.DataConfig(vocab_size=97, seq_len=16, global_batch=4, seed=3)
    a = Data.batch_for_step(cfg, 11)
    b = Data.batch_for_step(cfg, 11)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = Data.batch_for_step(cfg, 12)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_host_sharding_disjoint():
    h0 = Data.DataConfig(vocab_size=97, seq_len=8, global_batch=8, seed=1,
                         n_hosts=2, host_id=0)
    h1 = Data.DataConfig(vocab_size=97, seq_len=8, global_batch=8, seed=1,
                         n_hosts=2, host_id=1)
    b0 = Data.batch_for_step(h0, 5)
    b1 = Data.batch_for_step(h1, 5)
    assert b0["tokens"].shape[0] == 4 and b1["tokens"].shape[0] == 4
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_loader_prefetch_and_straggler():
    cfg = Data.DataConfig(vocab_size=97, seq_len=8, global_batch=4, seed=0)
    loader = Data.DataLoader(cfg, prefetch=2)
    try:
        b = loader.next_batch(timeout=5.0)
        assert b["tokens"].shape == (4, 8) and b["_step"] == 0
        assert loader.next_batch(timeout=5.0)["_step"] == 1
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    stalled = Data.DataLoader(cfg, prefetch=1)
    stalled.close()
    while not stalled._q.empty():
        stalled._q.get_nowait()
    with pytest.raises(Data.StragglerTimeout):
        stalled.next_batch(timeout=0.05)


# ------------------------------------------------- against the JAX package


@needs_reference
@pytest.mark.parametrize("cfg", [
    dict(vocab_size=97, seq_len=16, global_batch=4, seed=3),
    dict(vocab_size=32000, seq_len=64, global_batch=8, seed=0, noise=0.3),
    dict(vocab_size=256, seq_len=8, global_batch=8, seed=1, n_hosts=2, host_id=1),
])
def test_batch_for_step_is_the_reference(cfg):
    for step in (0, 7, 123):
        mine = Data.batch_for_step(Data.DataConfig(**cfg), step)
        ref = RData.batch_for_step(RData.DataConfig(**cfg), step)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(mine[k], ref[k])


def _ref_state(seed=0):
    k = jax.random.key(seed)
    return {
        "params": {
            "w": jax.random.normal(k, (8, 16), jnp.float32),
            "b16": jax.random.normal(k, (4, 4)).astype(jnp.bfloat16),
            "nested": ({"a": jnp.arange(5)},),
        },
        "opt": {"m": jnp.zeros((8, 16)), "step": jnp.int32(7)},
    }


def _files(path) -> tuple[dict, dict]:
    with open(Path(path) / "manifest.json") as f:
        manifest = json.load(f)
    with np.load(Path(path) / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, arrays


@needs_reference
def test_reference_checkpoint_restores_in_the_port(tmp_path):
    st = _ref_state()
    RCkpt.save(str(tmp_path), 4, st)
    like = {"params": {"w": torch.empty(8, 16), "b16": torch.empty(4, 4),
                       "nested": ({"a": torch.empty(5)},)},
            "opt": {"m": torch.empty(8, 16), "step": torch.empty(())}}
    restored, step = Ckpt.restore(str(tmp_path), like)
    assert step == 4
    assert restored["params"]["b16"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 7
    for got, want in zip(Opt.tree_leaves(restored), jax.tree.leaves(st)):
        want = np.asarray(want)
        assert str(got.dtype)[6:] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@needs_reference
def test_port_checkpoint_restores_in_the_reference(tmp_path):
    st = _state()
    Ckpt.save(str(tmp_path / "port"), 4, st)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), _ref_state())
    restored, step = RCkpt.restore(str(tmp_path / "port"), like)
    assert step == 4
    assert restored["params"]["b16"].dtype == jnp.bfloat16
    for got, want in zip(jax.tree.leaves(restored), Opt.tree_leaves(st)):
        np.testing.assert_array_equal(np.asarray(got, np.float32), want.float().numpy())
    # the same files: manifest (keys, order, shapes, dtypes) and array keys
    ref_st = jax.tree.map(np.asarray, _ref_state())
    ref_st["params"]["nested"] = ({"a": np.arange(5, dtype=np.int32)},)
    RCkpt.save(str(tmp_path / "ref"), 4, ref_st)
    pm, pa = _files(tmp_path / "port" / "step_00000004")
    rm, ra = _files(tmp_path / "ref" / "step_00000004")
    assert pm == rm and list(pm["leaves"]) == list(rm["leaves"])
    assert list(pa) == list(ra) and all(pa[k].dtype == ra[k].dtype for k in pa)
    assert (tmp_path / "port" / "LATEST").read_text() == (tmp_path / "ref" / "LATEST").read_text()


# ---------------------------------------------------------- fault tolerance


CLI = ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
       "--ckpt-every", "4", "--log-every", "4"]


def _final(ckpt_dir, steps):
    with np.load(Path(ckpt_dir) / f"step_{steps:08d}" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def test_cli_resume_after_injected_failure_is_bitwise(tmp_path, capsys):
    full = train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(SystemExit) as exc:
        train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at-step", "6"])
    assert exc.value.code == 42
    assert Ckpt.latest_step(str(tmp_path / "b")) == 4
    tail = train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "INJECTED FAILURE at step 6" in out and "resumed from step 4" in out
    assert tail == full[4:]
    a, b = _final(tmp_path / "a", 12), _final(tmp_path / "b", 12)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_cli_microbatches_and_adamw8(tmp_path):
    losses = train_cli.main(["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
                             "--opt", "adamw8", "--microbatches", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 4 and np.isfinite(losses).all()
    manifest, arrays = _files(tmp_path / "step_00000004")
    assert manifest["leaves"]["opt/m/embed/q"]["dtype"] == "int8"
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
    assert arrays["params/embed"].dtype == np.uint16


def test_elastic_completes_with_one_restart(tmp_path, monkeypatch):
    """The supervisor runs the train CLI as a child process, which dies at
    step 15 (exit 42), restarts it from the step-10 checkpoint, and ends with
    the checkpoint an uninterrupted child writes."""
    monkeypatch.setenv("PYTHONPATH", str(SRC))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the same in every child, few beside xdist
    restarts = elastic.run_supervised(24, 15, str(tmp_path / "e"), device="cpu")
    assert restarts == 1
    base = [sys.executable, "-m", "repro_torch.launch.train", "--steps", "24", "--batch", "4",
            "--seq", "64", "--ckpt-dir", str(tmp_path / "u"), "--ckpt-every", "10",
            "--device", "cpu"]
    subprocess.run(base, check=True, capture_output=True, timeout=300)
    a, b = _final(tmp_path / "e", 24), _final(tmp_path / "u", 24)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_example_train_lm_torch_loss_falls(monkeypatch, capsys):
    """examples/train_lm_torch.py on the CPU: 200 reduced steps, the loss
    falls by 0.5 (the example's own assertion, the reference example's)."""
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", SRC.parent / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train_lm_torch.py", "--device", "cpu"])
    mod.main()
    assert "OK: loss fell" in capsys.readouterr().out


def test_restore_rejects_what_the_checkpoint_does_not_hold(tmp_path):
    with pytest.raises(FileNotFoundError):
        Ckpt.restore(str(tmp_path), _state())
    Ckpt.save(str(tmp_path), 2, _state())
    like = _state()
    like["opt"]["m"] = torch.zeros(8, 15)
    with pytest.raises(ValueError, match="opt/m"):
        Ckpt.restore(str(tmp_path), like)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-small"])
def test_cli_feeds_the_front_end_stubs(arch, tmp_path):
    """The vision and encoder configs train through the CLI on its seeded
    stub patches / frames, and resume from their checkpoint."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--ckpt-dir"]
    full = train_cli.main(argv + [str(tmp_path / "a")])
    assert len(full) == 3 and np.isfinite(full).all()
    with pytest.raises(SystemExit):
        train_cli.main(argv + [str(tmp_path / "b"), "--fail-at-step", "2"])
    assert train_cli.main(argv + [str(tmp_path / "b"), "--resume"]) == full[2:]
