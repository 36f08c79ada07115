"""Assigned architecture configs (--arch <id>) + the paper's own serve config.

Each module exposes CONFIG (full-scale: the published widths) and REDUCED
(same family, small enough for the CPU tests).  get(name) resolves by id.
The same data as the JAX package's configs, kept here so that the port
imports nothing of that package.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "yi_6b",
    "granite_20b",
    "tinyllama_1_1b",
    "gemma3_1b",
    "jamba_v0_1_52b",
    "kimi_k2_1t_a32b",
    "dbrx_132b",
    "llava_next_mistral_7b",
    "whisper_small",
    "rwkv6_7b",
]

ALIASES = {
    "yi-6b": "yi_6b",
    "granite-20b": "granite_20b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma3-1b": "gemma3_1b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "dbrx-132b": "dbrx_132b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-small": "whisper_small",
    "rwkv6-7b": "rwkv6_7b",
    "veloann": "veloann",
}


def get(name: str, reduced: bool = False):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
