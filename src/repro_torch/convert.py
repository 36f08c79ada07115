"""Carry state built elsewhere into this package's objects.

An index is the quantized base (``QuantizedBase``) and the proximity graph
(``VamanaGraph``).  Another build of the same system — the JAX package, or a
saved image — hands them over as plain values: NumPy arrays, ints, floats and
the affinity map as a dict.  ``index_from_reference`` checks that every field
is present with the type this package stores (``metric``, ``in_dim`` and
``cr``, which the reference's squared-L2 base lacks, may be left out), and
copies the arrays, so both sides then search one index bit for bit without
sharing memory.

The ``velo`` device plane's image (``velo.index.DeviceIndex``: the tables
with the sentinel row appended, adjacency with -1 padding replaced by n)
travels the same way: ``device_index_from_reference`` takes the reference
``DeviceIndex``'s fields as NumPy arrays, checks their dtypes, shapes, the
ids and the sentinel row, and builds the port's on a device (ids become
int64), so both packages run ``batch_search`` and ``scan_search`` over one
index image.

An optimizer state travels the same way: ``opt_state_from_reference``
takes the reference's AdamW or AdamW8 state (``m``, ``v`` and ``step``, the
moments as float32 trees or as int8 codes with their scales) and builds the
port's, so a train step can start from one state in both packages.

A paged KV pool mid-run travels the same way: ``kv_pool_from_reference``
takes its pages, page states, owners, clock hand, block tables, swap store
and counters as plain values and builds a ``PagedKVPool`` that continues
from exactly that state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quant import QuantizedBase
from repro_torch.core.vamana import VamanaGraph
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.velo.index import DeviceIndex, from_arrays

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


# the port's inner-product fields of QuantizedBase, which the reference's
# squared-L2 base lacks
_OPTIONAL = frozenset({"metric", "in_dim", "cr"})


def _check_keys(kind: str, given: dict, cls) -> None:
    missing = _fields(cls) - set(given) - _OPTIONAL
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
        metric=str(qb.get("metric", "l2")),
        in_dim=None if qb.get("in_dim") is None else int(qb["in_dim"]),
        cr=None if qb.get("cr") is None else _array("qb", "cr", qb["cr"], np.float32),
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


# DeviceIndex field -> the dtype the reference's from_host gives it
_DEVICE_INDEX_ARRAYS = {
    "centroid": np.float32,
    "rotation": np.float32,
    "binary_codes": np.uint8,
    "norms": np.float32,
    "ip_bar": np.float32,
    "ext_codes": np.uint8,
    "ext_lo": np.float32,
    "ext_step": np.float32,
    "adjacency": np.int32,
    "medoid": np.int32,
}


def device_index_from_reference(
    fields: dict[str, np.ndarray], device: str | torch.device | None = None
) -> DeviceIndex:
    """The port's ``DeviceIndex`` on ``device`` (None: the process default,
    the CUDA card) from the reference ``DeviceIndex``'s fields as NumPy
    arrays: n + 1 rows of codes and tables (the last the sentinel: zero
    codes, norm 1e30, ip_bar 1, ext_lo 0, ext_step 1, adjacency all n),
    a (d, d) rotation, adjacency ids in [0, n] and a medoid in [0, n)."""
    _check_keys("device_index", fields, DeviceIndex)
    arr = {k: _array("device_index", k, fields[k], t) for k, t in _DEVICE_INDEX_ARRAYS.items()}
    d = arr["centroid"].shape[0] if arr["centroid"].ndim == 1 else -1
    rows = arr["binary_codes"].shape[0]
    n = rows - 1
    shapes = dict(rotation=(d, d), binary_codes=(rows, d // 8), norms=(rows,), ip_bar=(rows,),
                  ext_codes=(rows, d // 2), ext_lo=(rows,), ext_step=(rows,), medoid=())
    for name, shape in shapes.items():
        if d <= 0 or d % 8 or n < 1 or arr[name].shape != shape:
            raise ValueError(f"device_index.{name}: expected shape {shape} for d={d}, n={n}, "
                             f"got {arr[name].shape}")
    adj = arr["adjacency"]
    if adj.ndim != 2 or adj.shape[0] != rows:
        raise ValueError(f"device_index.adjacency: expected ({rows}, R), got {adj.shape}")
    if adj.size and (adj.min() < 0 or adj.max() > n):
        raise ValueError(f"device_index.adjacency: ids must lie in [0, {n}] (n is the sentinel)")
    if not 0 <= int(arr["medoid"]) < n:
        raise ValueError(f"device_index.medoid {int(arr['medoid'])} outside [0, {n})")
    sentinel = (arr["norms"][n] == np.float32(1e30) and arr["ip_bar"][n] == 1.0
                and not arr["binary_codes"][n].any() and not arr["ext_codes"][n].any()
                and arr["ext_lo"][n] == 0.0 and arr["ext_step"][n] == 1.0
                and bool((adj[n] == n).all()))
    if not sentinel:
        raise ValueError("device_index: the last row must be the sentinel row")
    return from_arrays(arr, device)


_POOL_FIELDS = {"k_pages", "v_pages", "state", "owner", "hand", "requests", "swap",
                "hits", "misses", "evictions", "swap_ins"}


def kv_pool_from_reference(
    fields: dict[str, object], device: str | torch.device | None = None
) -> PagedKVPool:
    """A ``PagedKVPool`` on ``device`` in the state another build's pool
    hands over as plain values: ``k_pages``/``v_pages`` (P, page, KVH, Dh)
    float32 arrays, ``state`` (P,) int8, ``owner`` (P, 2) int64,
    ``hand``, ``requests`` as {rid: (block_table, context_len)}, ``swap`` as
    {(rid, logical_page): (k, v)} with (page, KVH, Dh) arrays, and the
    counters ``hits``, ``misses``, ``evictions`` and ``swap_ins``."""
    missing, extra = _POOL_FIELDS - set(fields), set(fields) - _POOL_FIELDS
    if missing or extra:
        raise ValueError(
            f"kv_pool: missing fields {sorted(missing)}, unknown fields {sorted(extra)}")
    k_pages = _array("kv_pool", "k_pages", fields["k_pages"], np.float32)
    v_pages = _array("kv_pool", "v_pages", fields["v_pages"], np.float32)
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("kv_pool.k_pages and v_pages must both be (P, page, KVH, Dh)")
    n_pages, page, kvh, dh = k_pages.shape
    state = _array("kv_pool", "state", fields["state"], np.int8)
    owner = _array("kv_pool", "owner", fields["owner"], np.int64)
    if state.shape != (n_pages,) or owner.shape != (n_pages, 2):
        raise ValueError("kv_pool.state must be (P,) and kv_pool.owner (P, 2)")
    hand = int(fields["hand"])
    if not 0 <= hand < n_pages:
        raise ValueError(f"kv_pool.hand {hand} outside [0, {n_pages})")

    pool = PagedKVPool(n_pages, page, kvh, dh, dtype=torch.float32, device=device)
    pool.k_pages.copy_(torch.from_numpy(k_pages))
    pool.v_pages.copy_(torch.from_numpy(v_pages))
    pool.state[:] = state
    pool.owner[:] = owner
    pool.hand = hand
    for rid, (block_table, context_len) in dict(fields["requests"]).items():
        req = pool.add_request(int(rid))
        req.block_table = [int(p) for p in block_table]
        req.context_len = int(context_len)
    for (rid, lp), (k, v) in dict(fields["swap"]).items():
        pair = []
        for name, arr in (("k", k), ("v", v)):
            arr = _array("kv_pool", f"swap[{rid}, {lp}].{name}", arr, np.float32)
            if arr.shape != (page, kvh, dh):
                raise ValueError(f"kv_pool.swap[{rid}, {lp}].{name} must be (page, KVH, Dh)")
            pair.append(torch.from_numpy(arr))
        pool.swap[(int(rid), int(lp))] = (pair[0], pair[1])
    for name in ("hits", "misses", "evictions", "swap_ins"):
        setattr(pool, name, int(fields[name]))
    return pool


_LM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def lm_params_from_reference(tree, device: str | torch.device):
    """The JAX package's ``models.model.init_params`` tree, its leaves as
    NumPy arrays (stacked groups and tuples as they are), as the port's
    tensors on ``device``, one to one.  bfloat16 leaves (ml_dtypes) go
    through float32, which holds every bfloat16 value exactly."""
    if isinstance(tree, dict):
        return {k: lm_params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(lm_params_from_reference(v, device) for v in tree)
    arr = np.asarray(tree)
    dtype = _LM_DTYPES.get(arr.dtype.name)
    if dtype is None:
        raise ValueError(f"lm_params_from_reference: unexpected leaf dtype {arr.dtype}")
    t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return t.to(device=device, dtype=dtype)


_OPT_DTYPES = {"float32": torch.float32, "int8": torch.int8, "int32": torch.int32}


def opt_state_from_reference(tree, device: str | torch.device):
    """The JAX package's ``train.optimizer`` state as the port's on
    ``device``: a dict with ``m``, ``v`` (trees shaped like the parameters;
    AdamW: float32 leaves, AdamW8: ``{"q": int8, "s": float32}`` and
    ``{"q", "s", "mn"}`` at each parameter's place) and ``step``, a 0-d
    int32; leaves as NumPy arrays, dtypes kept."""
    if not isinstance(tree, dict) or set(tree) != {"m", "v", "step"}:
        raise ValueError("opt_state_from_reference: expected a dict with m, v and step")
    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt_state_from_reference: step must be a 0-d int32, got "
                         f"{step.dtype} {step.shape}")

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(conv(v) for v in t)
        arr = np.asarray(t)
        dtype = _OPT_DTYPES.get(arr.dtype.name)
        if dtype is None:
            raise ValueError(f"opt_state_from_reference: unexpected leaf dtype {arr.dtype}")
        return torch.from_numpy(np.array(arr, order="C")).to(device)

    return {"m": conv(tree["m"]), "v": conv(tree["v"]), "step": conv(step)}
