"""examples/rag_serving_torch.py against the steps of examples/rag_serving.py.

Both sides build the example's 3 000 x 64 corpus index with their own
package (the port's must equal the reference's array for array), run the
reduced tinyllama in float32 on the weights of the reference's
``init_params(jax.random.key(0))``, prefill the example's seeded prompts,
and decode four greedy steps from fresh caches, each retrieving top-5 with
``batch_search``.  The sampled tokens and the retrieved ids must be equal at
every step.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import dataset as ref_dataset  # noqa: E402
from repro.core import vamana as ref_vamana  # noqa: E402
from repro.core.quant import RabitQuantizer as RefQuantizer  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.velo import batch_search as ref_batch_search  # noqa: E402
from repro.velo.index import from_host as ref_from_host  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def example():
    torch.set_num_threads(2)
    spec = importlib.util.spec_from_file_location(
        "rag_serving_torch", ROOT / "examples" / "rag_serving_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def indexes(example):
    ds = ref_dataset.make_dataset(n=3000, d=64, n_queries=10, k=5, seed=5)
    graph = ref_vamana.build_vamana(ds.base, R=16, L=32, seed=5, two_pass=False)
    qb = RefQuantizer(64, seed=5).fit_encode(ds.base)
    return ref_from_host(qb, graph), example.build_index("cpu")


def _reference_steps(cfg, params, index, tokens):
    """examples/rag_serving.py's loop, on a given config and weights."""
    model = RM.build(cfg)
    B, S = tokens.shape
    logits, _ = jax.jit(lambda p, b: RM.prefill(model, p, b))(
        params, {"tokens": tokens, "labels": tokens})
    caches = RM.init_decode_caches(model, B, cache_len=S + 8)
    decode = jax.jit(lambda p, c, t, pos: RM.decode_step(model, p, c, t, pos))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = []
    for step in range(4):
        logits, caches = decode(params, caches, tok, jnp.int32(S + step))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        h = np.asarray(RL.embed(tok, params["embed"]).astype(jnp.float32))
        ids, _, _ = ref_batch_search.batch_search(index, jnp.asarray(h[:, :64]), L=32, k=5)
        out.append((np.asarray(tok), np.asarray(ids)))
    return out


def test_the_port_builds_the_reference_index(indexes):
    ref, mine = indexes
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        got = getattr(mine, f.name)
        if hasattr(want, "shape"):
            np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want), err_msg=f.name)


def test_tokens_and_retrieved_ids_equal_the_reference_example(example, indexes):
    ref_index, index = indexes
    cfg = dataclasses.replace(ref_configs.get("tinyllama-1.1b", reduced=True), dtype="float32")
    ref_params = RM.init_params(RM.build(cfg), jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (example.B, example.S)).astype(np.int32)
    want = _reference_steps(cfg, ref_params, ref_index, jnp.asarray(tokens))

    model = PM.build(dataclasses.replace(configs.get("tinyllama-1.1b", reduced=True),
                                         dtype="float32"))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref_params), "cpu")
    got = example.serve(model, params, index, torch.from_numpy(tokens).long())
    assert len(got) == len(want) == 4
    for step, ((tok, ids), (ref_tok, ref_ids)) in enumerate(zip(got, want)):
        assert tok.tolist() == ref_tok.tolist(), f"step {step}"
        assert ids.tolist() == ref_ids.tolist(), f"step {step}"


def test_main_on_the_cpu(example, indexes, monkeypatch, capsys):
    monkeypatch.setattr(example, "build_index", lambda device: indexes[1])
    example.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == [f"decode step {i}" for i in range(4)]
    assert lines[-1] == "OK: decode loop with per-step ANN retrieval"


def test_main_defaults_to_the_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([])
