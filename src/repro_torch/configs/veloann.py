"""The paper's own config: the VeloANN distributed serve cell.

Corpus sharded over every mesh device; scan-mode two-stage search per shard
(binary MXU sweep -> int4 rerank) + distributed top-k merge.  Sized so one
v5e chip's shard fits comfortably in HBM with the level-1/level-2 artifacts:
  corpus 512M vectors x d=128 -> 1M vectors/chip at 512 chips:
  binary 16 B + ext 64 B + adj 128 B + meta ~= 220 B/vec ~= 220 MB/chip.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class VeloServeConfig:
    name: str = "veloann"
    corpus_size: int = 512 * 1024 * 1024   # global vectors
    dim: int = 128
    R: int = 32                             # graph degree
    query_batch: int = 4096                 # global concurrent queries
    k: int = 10
    rerank: int = 64                        # stage-2 candidates per shard
    mode: str = "scan"                      # scan | graph


CONFIG = VeloServeConfig()

REDUCED = VeloServeConfig(
    name="veloann-reduced",
    corpus_size=4096,
    dim=64,
    R=12,
    query_batch=32,
    k=10,
    rerank=32,
)
