"""Train a reduced LM for a few hundred steps on synthetic data with the
PyTorch port (the steps of examples/train_lm.py) — the training substrate
end to end (data pipeline -> train step -> optimizer -> checkpointing),
with a falling loss.  On the card, every attention layer's forward runs the
hand-written flash_attention kernel.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--opt adamw8]   # the card
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""

import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.launch import train as train_cli  # noqa: E402


def main():
    argv = sys.argv[1:] or []
    losses = train_cli.main(
        ["--arch", "tinyllama-1.1b", "--steps", "200", "--batch", "8",
         "--seq", "64", "--lr", "3e-3", "--log-every", "20"] + argv
    )
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first - 0.5, f"loss did not fall: {first:.3f} -> {last:.3f}"
    print("OK: loss fell", f"{first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    main()
