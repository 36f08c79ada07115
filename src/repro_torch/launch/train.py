"""Training CLI: real steps on synthetic data with checkpointing.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--resume] [--device cpu]

Trains on ``--device``: the CUDA card by default, which must be there;
``--device cpu`` runs the kernels' plain PyTorch versions.  ``--reduced``
(the default) takes the architecture's reduced config; ``--no-reduced``
trains it at its published widths.  The step is
``train.train_step.make_train_step``'s; the data is the deterministic
``(seed, step)`` stream of ``train.data``, so a run resumed from a
checkpoint takes the same steps as an uninterrupted one.  ``main(argv)``
returns the per-step losses.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as Mod
from repro_torch.train import checkpoint as Ckpt
from repro_torch.train import data as Data
from repro_torch.train import optimizer as Opt
from repro_torch.train import train_step as TS


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the reduced config (default); --no-reduced: the published widths")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adamw8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a crash (fault-tolerance testing)")
    ap.add_argument("--device", default="cuda",
                    help='"cuda", "cuda:N" or "cpu" (default: the CUDA card)')
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, reduced=args.reduced)
    model = Mod.build(cfg)
    opt_cfg = Opt.OptConfig(lr=args.lr, total_steps=args.steps, warmup_steps=max(1, args.steps // 20))
    step_fn = TS.make_train_step(
        model, opt_name=args.opt, opt_cfg=opt_cfg,
        microbatches=args.microbatches, ce_chunk=64,
    )
    init_fn = TS.make_init(model, args.opt)

    dcfg = Data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
    )

    start_step = 0
    params, opt_state = init_fn(torch.Generator(device=dev).manual_seed(args.seed))
    if args.resume and args.ckpt_dir and Ckpt.latest_step(args.ckpt_dir) is not None:
        state, start_step = Ckpt.restore(
            args.ckpt_dir, {"params": params, "opt": opt_state}, dev
        )
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start_step}", flush=True)

    def stub(step, tokens):  # the vision / encoder front ends' stub inputs
        rng = np.random.default_rng(step)
        x = rng.standard_normal((args.batch, tokens, cfg.d_model))
        return torch.from_numpy(x).to(device=dev, dtype=torch.bfloat16)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        if args.fail_at_step is not None and step == args.fail_at_step:
            print(f"[train] INJECTED FAILURE at step {step}", flush=True)
            raise SystemExit(42)
        batch = Data.batch_for_step(dcfg, step)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
                 if not k.startswith("_")}
        if cfg.frontend == "vision":
            batch["patches"] = stub(step, cfg.frontend_tokens)
        if cfg.n_encoder_layers:
            batch["frames"] = stub(step, cfg.encoder_tokens)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            Ckpt.save(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state})

    if args.ckpt_dir:
        Ckpt.save(args.ckpt_dir, args.steps, {"params": params, "opt": opt_state})
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})", flush=True)
    return losses


if __name__ == "__main__":
    main()
