"""Retrieval-augmented serving on the PyTorch port: LM decode consulting the
ANN engine (the steps of examples/rag_serving.py).

A reduced tinyllama-family model prefills a batch of prompts, then decodes
greedily; every decode step embeds the sampled token (a stub projection into
the corpus space) and retrieves its top-5 neighbours from the VeloANN device
index with ``velo.batch_search``.  Prefill attention runs on the
hand-written flash_attention kernel on the card.  As in the JAX example,
decode starts from fresh (zero) caches, not from the prefill's.

  PYTHONPATH=src python examples/rag_serving_torch.py                # the card
  PYTHONPATH=src python examples/rag_serving_torch.py --device cpu
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import dataset, vamana  # noqa: E402
from repro_torch.core.quant import RabitQuantizer  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as Mod  # noqa: E402
from repro_torch.velo import batch_search  # noqa: E402
from repro_torch.velo.index import from_host  # noqa: E402

B, S, STEPS = 4, 16, 4


def build_index(device):
    """The retrieval corpus: 3 000 documents embedded in a d=64 space."""
    ds = dataset.make_dataset(n=3000, d=64, n_queries=10, k=5, seed=5)
    graph = vamana.build_vamana(ds.base, R=16, L=32, seed=5, two_pass=False)
    qb = RabitQuantizer(64, seed=5).fit_encode(ds.base)
    return from_host(qb, graph, device=device)


def serve(model, params, index, tokens: torch.Tensor, steps: int = STEPS):
    """Prefill ``tokens`` (B, S), then ``steps`` greedy decode steps, each
    retrieving top-5 for the sampled token's embedding.  Returns per step
    (tokens (B,), retrieved ids (B, 5))."""
    Bsz, Sp = tokens.shape
    out = []
    with torch.no_grad():
        logits, _ = Mod.prefill(model, params, {"tokens": tokens, "labels": tokens})
        caches = Mod.init_decode_caches(model, Bsz, cache_len=Sp + 8, device=tokens.device)
        tok = logits.argmax(dim=-1)
        for step in range(steps):
            logits, caches = Mod.decode_step(model, params, caches, tok, Sp + step)
            tok = logits.argmax(dim=-1)
            # retrieval query = current hidden proxy: embed of the sampled
            # token (stub projection into the corpus space)
            h = L.embed(tok, params["embed"]).float()
            ids, _, _ = batch_search.batch_search(index, h[:, :64], L=32, k=5)
            out.append((tok, ids))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    index = build_index(dev)
    # a reduced LM (d_model=64 matches the corpus space for the stub)
    cfg = configs.get("tinyllama-1.1b", reduced=True)
    model = Mod.build(cfg)
    params = Mod.init_params(model, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    for step, (tok, ids) in enumerate(serve(model, params, index, tokens)):
        print(f"decode step {step}: tokens={tok.tolist()} "
              f"retrieved_docs={ids[:, :3].tolist()}")
    print("OK: decode loop with per-step ANN retrieval")


if __name__ == "__main__":
    main()
