"""Carry an index image built elsewhere into this package's dataclasses.

An index is the quantized base (``QuantizedBase``) and the proximity graph
(``VamanaGraph``).  Another build of the same system — the JAX package, or a
saved image — hands them over as plain values: NumPy arrays, ints, floats and
the affinity map as a dict.  ``index_from_reference`` checks that every field
is present with the type this package stores, and copies the arrays, so both
sides then search one index bit for bit without sharing memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.quant import QuantizedBase
from repro_torch.core.vamana import VamanaGraph

# array field -> the dtype the build gives it
_QB_ARRAYS = {
    "centroid": np.float32,
    "rotation": np.float32,
    "binary_codes": np.uint8,
    "norms": np.float32,
    "ip_bar": np.float32,
    "ext_codes": np.uint8,
    "ext_lo": np.float32,
    "ext_step": np.float32,
}
_GRAPH_ARRAYS = {"adjacency": np.int32, "degrees": np.int32}


def _fields(cls) -> set[str]:
    return {f.name for f in dataclasses.fields(cls)}


def _check_keys(kind: str, given: dict, cls) -> None:
    missing = _fields(cls) - set(given)
    extra = set(given) - _fields(cls)
    if missing or extra:
        raise ValueError(
            f"{kind}: missing fields {sorted(missing)}, unknown fields {sorted(extra)}"
        )


def _array(kind: str, name: str, value, dtype) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype != dtype:
        raise ValueError(f"{kind}.{name}: expected {np.dtype(dtype)}, got {arr.dtype}")
    return np.array(arr, copy=True, order="C")


def index_from_reference(
    qb: dict[str, np.ndarray | int], graph: dict[str, object]
) -> tuple[QuantizedBase, VamanaGraph]:
    """(QuantizedBase, VamanaGraph) from the plain-value fields of another
    build: ``qb`` holds every ``QuantizedBase`` field and ``graph`` every
    ``VamanaGraph`` field (``affinity`` as {vid: [(vid, d2), ...]})."""
    _check_keys("qb", qb, QuantizedBase)
    _check_keys("graph", graph, VamanaGraph)
    out_qb = QuantizedBase(
        **{k: _array("qb", k, qb[k], t) for k, t in _QB_ARRAYS.items()},
        dim=int(qb["dim"]),
        ext_bits=int(qb["ext_bits"]),
    )
    n = out_qb.binary_codes.shape[0]
    if out_qb.binary_codes.shape != (n, out_qb.dim // 8):
        raise ValueError("qb.binary_codes must be (n, dim/8)")
    affinity = {
        int(p): [(int(v), float(d2)) for v, d2 in cands]
        for p, cands in dict(graph["affinity"]).items()
    }
    out_graph = VamanaGraph(
        **{k: _array("graph", k, graph[k], t) for k, t in _GRAPH_ARRAYS.items()},
        medoid=int(graph["medoid"]),
        R=int(graph["R"]),
        affinity=affinity,
        tau=float(graph["tau"]),
    )
    if out_graph.adjacency.shape != (n, out_graph.R):
        raise ValueError("graph.adjacency must be (n, R) with the quantized base's n")
    return out_qb, out_graph
