"""An inner-product scan deployment: big-ann-benchmarks' text2image-1B.

Yandex Text-to-Image: 10^9 image embeddings of 200 float32 dimensions,
searched by inner product with text-embedding queries from another
distribution (out of distribution), k 10.  Served as ``veloann.py``'s scan:
the corpus spread over 512 chips, each scanning its share of
10^9 / 512 = 1 953 125 rows for every query of a 4 096-query batch (stage 1
the binary sweep over the codes padded to D 224, stage 2 the int4 rerank of
64 candidates).  Per row on a chip: 28 B of sign codes, 112 B of int4 codes,
20 B of tables and, for ``R``, 256 B of adjacency that scan mode never reads.
"""

from repro_torch.configs.veloann import VeloServeConfig

METRIC = "ip"  # the quantizer's metric: RabitQuantizer(dim, metric=METRIC)

CONFIG = VeloServeConfig(
    name="text2image",
    corpus_size=10**9,
    dim=200,
    R=32,
    query_batch=4096,
    k=10,
    rerank=64,
)

REDUCED = VeloServeConfig(
    name="text2image-reduced",
    corpus_size=3000,
    dim=200,
    R=12,
    query_batch=16,
    k=10,
    rerank=32,
)
