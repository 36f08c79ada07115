"""DeviceIndex: the compressed VeloANN index as a dataclass of tensors.

Shares the exact artifact format with the host plane (core.quant /
core.vamana): binary codes + norms + ip_bar steer traversal, 4-bit ext codes
refine, padded adjacency drives graph gathers.  A sentinel row is appended so
padding ids (-1 -> n) gather safely and estimate to +inf: its norm is 1e30,
whose square overflows to inf in float32.  Ids on the device are int64 (the
reference keeps int32); the values are the same.

An inner-product index (``metric == "ip"``, from a ``RabitQuantizer(...,
metric="ip")`` base) also carries ``cr``, the per-row ``<c, o - c>``, and
``in_dim``, the queries' width before the padding to ``dim``.  These are
attributes, not dataclass fields: the fields stay the reference's image, and
a squared-L2 index reads ``metric`` "l2", ``in_dim`` ``dim`` and ``cr`` None.
The sentinel's ``cr`` is -inf, so that it ranks last under inner product
too: its estimate and its refined score, both ``-(cr + ...)``, are +inf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quant import padded_dim
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DeviceIndex:
    centroid: torch.Tensor       # (d,) float32
    rotation: torch.Tensor       # (d, d) float32
    binary_codes: torch.Tensor   # (n+1, d/8) uint8
    norms: torch.Tensor          # (n+1,) float32 — sentinel row: 1e30
    ip_bar: torch.Tensor         # (n+1,) float32
    ext_codes: torch.Tensor      # (n+1, d/2) uint8
    ext_lo: torch.Tensor         # (n+1,) float32
    ext_step: torch.Tensor       # (n+1,) float32
    adjacency: torch.Tensor      # (n+1, R) int64, -1 padding replaced by n
    medoid: torch.Tensor         # () int64

    def __post_init__(self):
        self.metric = "l2"
        self.in_dim = self.dim
        self.cr: torch.Tensor | None = None  # (n+1,) float32 <c, o - c>: inner product only

    @property
    def n(self) -> int:
        return self.binary_codes.shape[0] - 1

    @property
    def dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def R(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.binary_codes.device


def from_arrays(arrays: dict[str, np.ndarray],
                device: str | torch.device | None = None, *, in_dim: int | None = None,
                cr: np.ndarray | None = None) -> DeviceIndex:
    """A DeviceIndex on ``device`` (None: the process default, the CUDA
    card) from its fields as NumPy arrays (the sentinel row included); ids
    become int64.  ``in_dim`` (None: the index's width) and ``cr`` (n + 1
    rows) as in the module's docstring: with ``cr`` the index is inner
    product's."""
    dev = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        t = torch.from_numpy(np.array(arr, order="C"))  # a copy: writable, 0-d kept
        if name in ("adjacency", "medoid"):
            t = t.to(torch.int64)
        out[name] = t.to(dev)
    index = DeviceIndex(**out)
    index.metric = "l2" if cr is None else "ip"
    index.in_dim = index.dim if in_dim is None else int(in_dim)
    if cr is not None:
        index.cr = torch.from_numpy(np.asarray(cr, np.float32).copy()).to(dev)
    return index


def from_host(qb, graph, device: str | torch.device | None = None) -> DeviceIndex:
    """Build the device image from host-plane artifacts (QuantizedBase +
    VamanaGraph) on ``device`` (None: the process default, the CUDA card):
    the reference's ``from_host`` arrays, value for value.  A base without
    the port's ``metric``, ``in_dim`` and ``cr`` (the reference's) is
    squared L2's."""
    n = qb.norms.shape[0]
    cr = getattr(qb, "cr", None)
    adj = graph.adjacency.copy()
    adj[adj < 0] = n  # sentinel
    sent_adj = np.full((1, adj.shape[1]), n, dtype=np.int32)
    big = np.float32(1e30)
    return from_arrays(dict(
        centroid=np.asarray(qb.centroid, np.float32),
        rotation=np.asarray(qb.rotation, np.float32),
        binary_codes=np.concatenate(
            [qb.binary_codes, np.zeros((1, qb.binary_codes.shape[1]), np.uint8)]),
        norms=np.concatenate([qb.norms, [big]]).astype(np.float32),
        ip_bar=np.concatenate([qb.ip_bar, [1.0]]).astype(np.float32),
        ext_codes=np.concatenate([qb.ext_codes, np.zeros((1, qb.ext_codes.shape[1]), np.uint8)]),
        ext_lo=np.concatenate([qb.ext_lo, [0.0]]).astype(np.float32),
        ext_step=np.concatenate([qb.ext_step, [1.0]]).astype(np.float32),
        adjacency=np.concatenate([adj, sent_adj]).astype(np.int32),
        medoid=np.asarray(graph.medoid, dtype=np.int32),
    ), device, in_dim=getattr(qb, "in_dim", None),
        cr=None if cr is None else np.concatenate([cr, [-np.inf]]).astype(np.float32))


def synthetic_specs(n: int, d: int, R: int, metric: str = "l2") -> DeviceIndex:
    """Shape-only stand-ins on the meta device (no allocation) of an index
    of n rows of width d: for inner product the tables are over d padded to
    a multiple of 32, with a ``cr`` table."""
    f32, u8, i64 = torch.float32, torch.uint8, torch.int64
    in_dim, d = d, padded_dim(d, metric)

    def S(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    index = DeviceIndex(
        centroid=S((d,), f32),
        rotation=S((d, d), f32),
        binary_codes=S((n + 1, d // 8), u8),
        norms=S((n + 1,), f32),
        ip_bar=S((n + 1,), f32),
        ext_codes=S((n + 1, d // 2), u8),
        ext_lo=S((n + 1,), f32),
        ext_step=S((n + 1,), f32),
        adjacency=S((n + 1, R), i64),
        medoid=S((), i64),
    )
    index.metric, index.in_dim = metric, in_dim
    if metric == "ip":
        index.cr = S((n + 1,), f32)
    return index
