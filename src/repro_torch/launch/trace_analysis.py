"""Per-device FLOPs, op-boundary bytes, collective traffic and the peak of
live temporaries of one traced step: the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``.

Eager PyTorch has no HLO, so nothing here parses one.  A ``Trace`` is a
dispatch mode that sees every op the step runs on this rank's LOCAL tensors
(the per-rank code of ``models.sharding``; the dry run runs it on meta
tensors over a fake process group) and gives, per device:

  * FLOPs, by ``torch.utils.flop_counter`` (matmuls, batched matmuls,
    convolutions, attention ops; 2 per multiply-add, as the reference's dot
    accounting);
  * bytes at op boundaries: each op's input and output tensors, views and
    metadata ops excluded.  Like the reference's CPU-backend fusion-boundary
    bytes this is an UPPER bound on HBM traffic: an eager op is a boundary
    wherever a fused kernel would keep its operands on chip;
  * collective wire bytes, by the reference's ring accounting
    (``wire_bytes``), over the collectives the step issues through
    ``models.sharding``, with n the size of the collective's group;
  * the peak of live bytes of the tensors the step creates (its
    temporaries, activations kept for the backward included), for the dry
    run's memory estimate.

The reference corrects XLA's cost analysis for loop trip counts; an eager
loop runs, and is traced, once per iteration, so there is nothing to
correct.
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import sharding as Sh

_aten = torch.ops.aten
# ops that move no bytes (views, metadata, aliasing)
_NO_BYTES = {
    _aten.view, _aten._unsafe_view, _aten.t, _aten.transpose, _aten.permute, _aten.expand,
    _aten.slice, _aten.select, _aten.unbind, _aten.as_strided, _aten.detach, _aten.alias,
    _aten.unsqueeze, _aten.squeeze, _aten.split, _aten.split_with_sizes, _aten.chunk,
    _aten.diagonal, _aten.unfold, _aten.lift_fresh, _aten.empty, _aten.empty_strided,
    _aten.new_empty, _aten.new_empty_strided, _aten.movedim, _aten.reshape, _aten.narrow,
    _aten.view_as, _aten._reshape_alias, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.is_same_size, _aten.numel, _aten.dim, _aten.size, _aten.stride,
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements (a shape and a dtype: the reference's
    ``_shape_bytes`` of the same HLO shape)."""
    return t.numel() * t.element_size()


def wire_bytes(kind: str, in_bytes: float, out_bytes: float, n: int) -> float:
    """Per-device wire bytes of one collective by ring accounting, with ``n``
    the size of its group: all-gather out*(n-1)/n, all-reduce
    2*in*(n-1)/n, reduce-scatter and all-to-all in*(n-1)/n, permute in."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "all-reduce":
        return 2 * in_bytes * frac
    if kind in ("reduce-scatter", "all-to-all"):
        return in_bytes * frac
    if kind == "collective-permute":
        return in_bytes
    raise ValueError(kind)


def collective_stats(records) -> dict:
    """``records``: (kind, in bytes, out bytes, group size) per collective;
    the reference's ``collective_stats`` fields."""
    per_op = defaultdict(float)
    counts = defaultdict(float)
    for kind, ib, ob, n in records:
        per_op[kind] += wire_bytes(kind, ib, ob, n)
        counts[kind] += 1
    return {"collective_bytes_per_device": sum(per_op.values()), "by_op": dict(per_op),
            "counts": dict(counts)}


def _tensors(x):
    """The tensors of an op's arguments or results; a DTensor (an op on one
    runs its local op unseen by the trace) counts as its local tensor."""
    if isinstance(x, torch.Tensor):
        local = getattr(x, "_local_tensor", None)
        yield local if local is not None else x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class _Counts(TorchDispatchMode):
    """FLOPs (``torch.utils.flop_counter``'s formulas), op-boundary bytes, op
    counts, and the live bytes of the storages the traced ops create (a
    storage counts until its last tensor dies)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, list[int]] = {}

    def _release(self, key: int):
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _hold(self, t: torch.Tensor):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [st.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        flops = flop_registry.get(func.overloadpacket)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        if func.overloadpacket not in _NO_BYTES:
            self.bytes += sum(tensor_bytes(t) for t in _tensors(args))
            self.bytes += sum(tensor_bytes(t) for t in _tensors(kwargs))
            self.bytes += sum(tensor_bytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._hold(t)
        return out


class Trace:
    """``with Trace() as tr: step()`` -> ``tr.result()``: flops, op-boundary
    bytes, collectives and the peak of live temporaries of this rank."""

    def __init__(self):
        self._counts = _Counts()
        self.records: list = []

    def __enter__(self):
        self._prev = Sh.set_trace(self.records)
        self._counts.__enter__()
        return self

    def __exit__(self, *exc):
        self._counts.__exit__(*exc)
        Sh.set_trace(self._prev)

    def result(self) -> dict:
        c = self._counts
        return {
            "flops_per_device": float(c.flops),
            "bytes_per_device": float(c.bytes),
            "ops_executed": c.ops,
            "temp_peak_bytes": c.peak,
            "collectives": collective_stats(self.records),
        }
