"""Partition specs: parameters, activations, KV caches, optimizer state; and
the per-rank step's collectives.

The JAX package's strategy (its ``models/sharding.py``), on the port's
parameter trees:
  * TP over 'model'  — attention heads / FFN columns / vocab / experts (EP)
  * FSDP over 'data' — the non-TP dimension of every large weight is sharded
    over the data axis (gathered at use, gradients reduce-scattered)
  * DP over 'pod' x 'data' — the batch axis
Params are replicated across 'pod'; optimizer state mirrors the param specs.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name or a
tuple of axis names (the reference's ``PartitionSpec`` as plain data).
``named`` turns specs into DTensor placements, one per mesh dim: ``Shard(i)``
where the spec names that mesh axis on tensor dim ``i``, ``Replicate()``
elsewhere; ``place`` builds the DTensors from full tensors, every rank
slicing its own shard.

Where GSPMD partitions the reference's whole program from these specs, the
port's models run as explicit per-rank code under an active mesh: each rank
holds its shards (``Local``), gathers a weight at use (``use``) with the
collective whose backward is the one FSDP and Megatron TP need, and keeps
the residual stream in the Megatron layout the reference's ``constrain_act``
anchors (batch over the DP axes, features replicated over 'model').  TP
regions are entered with ``enter_tp`` (identity forward, all-reduce of the
gradient over 'model') and left with ``leave_tp`` (all-reduce forward,
identity backward).  Every collective goes through this module and is
recorded while a trace is open (``launch.trace_analysis``).

``set_active_mesh`` arms all of it; without an active mesh every helper
returns its input unchanged, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.distributed as dist

_ACTIVE = {"mesh": None, "dp": ("data",), "tp": "model", "trace": None, "dp_group": None}


def set_active_mesh(mesh, dp_axes=("data",), tp_axis="model"):
    """``mesh``: a ``DeviceMesh`` with named dims."""
    _ACTIVE["mesh"] = mesh
    _ACTIVE["dp"] = tuple(dp_axes)
    _ACTIVE["tp"] = tp_axis
    _ACTIVE["dp_group"] = None


def clear_active_mesh():
    _ACTIVE["mesh"] = None


def active() -> bool:
    return _ACTIVE["mesh"] is not None


def active_mesh():
    """The active ``DeviceMesh`` (``None`` without one)."""
    return _ACTIVE["mesh"]


def dp_axes():
    return _ACTIVE["dp"]


def tp_axis() -> str:
    return _ACTIVE["tp"]


def set_trace(records):
    """Record every collective into the list ``records`` (``None``: stop);
    returns the list recorded into before."""
    prev, _ACTIVE["trace"] = _ACTIVE["trace"], records
    return prev


def _names(mesh) -> tuple[str, ...]:
    return tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)


def _shape(mesh) -> tuple[int, ...]:
    if hasattr(mesh, "devices"):        # the reference's mesh (or a stand-in)
        return tuple(mesh.devices.shape)
    return tuple(mesh.shape)


def mesh_sizes(mesh=None) -> dict[str, int]:
    mesh = mesh if mesh is not None else _ACTIVE["mesh"]
    return dict(zip(_names(mesh), _shape(mesh)))


def size(axes) -> int:
    """The number of ranks over ``axes`` (a name or a tuple) on the active mesh."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    if not axes:
        return 1
    sizes = mesh_sizes()
    return math.prod(sizes.get(a, 1) for a in axes)


def coord(axis: str) -> int:
    return _ACTIVE["mesh"].get_local_rank(axis)


def dp_size() -> int:
    return size(_ACTIVE["dp"])


def dp_index() -> int:
    """This rank's block of a dim split over the DP axes (mesh order)."""
    idx = 0
    for a in _ACTIVE["dp"]:
        idx = idx * size(a) + coord(a)
    return idx


def tp_size() -> int:
    return size(_ACTIVE["tp"])


def _spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ------------------------------------------------------------ the param rules

# matched against the JOINED key path (e.g. "groups/3/attn/wq"); first match
# wins.  Specs are written for the UNSTACKED shape; a leading None is
# prepended automatically for stacked ("groups/...") leaves.
_RULES: list[tuple[str, tuple]] = [
    (r"embed$",            ("model", "data")),   # (V, D)
    (r"unembed$",          ("data", "model")),   # (D, V)
    (r"(attn|cross)/wq$",  ("data", "model")),
    (r"(attn|cross)/wk$",  ("data", "model")),
    (r"(attn|cross)/wv$",  ("data", "model")),
    (r"(attn|cross)/wo$",  ("model", "data")),
    (r"ffn/w_gate$",       ("data", "model")),
    (r"ffn/w_up$",         ("data", "model")),
    (r"ffn/w_down$",       ("model", "data")),
    (r"moe/router$",       ("data", None)),
    (r"moe/w_gate$",       ("model", "data", None)),   # (E, D, F): EP + FSDP
    (r"moe/w_up$",         ("model", "data", None)),
    (r"moe/w_down$",       ("model", None, "data")),
    (r"shared/w_gate$",    ("data", "model")),
    (r"shared/w_up$",      ("data", "model")),
    (r"shared/w_down$",    ("model", "data")),
    (r"mamba/in_proj$",    ("data", "model")),
    (r"mamba/conv_w$",     (None, "model")),
    (r"mamba/conv_b$",     ("model",)),
    (r"mamba/w_dt1$",      ("model", None)),
    (r"mamba/w_dt2$",      (None, "model")),
    (r"mamba/dt_bias$",    ("model",)),
    (r"mamba/w_B$",        ("model", None)),
    (r"mamba/w_C$",        ("model", None)),
    (r"mamba/A_log$",      ("model", None)),
    (r"mamba/D$",          ("model",)),
    (r"mamba/out_proj$",   ("model", "data")),
    (r"rwkv/w_o$",         ("model", "data")),
    (r"rwkv/w_[rkvg]$",    ("data", "model")),
    (r"rwkv/w_decay_a$",   ("data", None)),
    (r"rwkv/w_decay_b$",   (None, "model")),
    (r"rwkv/u_bonus$",     ("model", None)),
    (r"rwkv/cm_r$",        ("data", "model")),
    (r"rwkv/cm_k$",        ("data", "model")),
    (r"rwkv/cm_v$",        ("model", "data")),
    (r"rwkv/(mu_|ln_x|w_decay_base)", (None,)),
    (r"norm",              (None,)),
    (r".*",                (None,)),             # fallback: replicate
]


def _path_str(path) -> str:
    return "/".join(str(e) for e in path)


def _spec_for(path_str: str, ndim: int) -> tuple:
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            spec = tuple(spec)
            if path_str.startswith("groups") or "/groups" in path_str:
                spec = (None,) + spec
            return spec[:ndim] + (None,) * max(0, ndim - len(spec))
    return ()


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over nested dicts / tuples / lists
    (the path: dict keys and sequence indices)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def param_pspecs(params_shape) -> dict:
    """The spec tree of a param tree (tensors or anything with a ``shape``)."""
    return tree_map_with_path(lambda path, leaf: _spec_for(_path_str(path), len(leaf.shape)),
                              params_shape)


def check_divisible(params_shape, pspecs, mesh) -> tuple[dict, list[str]]:
    """(specs, degraded paths): a leaf whose sharded dims don't divide falls
    back to replication (every entry ``None``), as the reference's does
    (GSPMD would fail)."""
    sizes = mesh_sizes(mesh)
    bad = []

    def fix(path, leaf, spec):
        for dim, ax in enumerate(spec):
            total = math.prod(sizes[a] for a in _spec_axes(ax))
            if leaf.shape[dim] % total:
                bad.append(_path_str(path))
                return (None,) * len(spec)
        return spec

    return tree_map_with_path(fix, params_shape, pspecs), bad


def placements_of(mesh, spec) -> tuple:
    """DTensor placements of one spec on ``mesh``: per mesh dim, ``Shard(i)``
    where tensor dim ``i`` names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in _names(mesh):
        dims = [i for i, e in enumerate(spec) if name in _spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, (tuple, list)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    return specs  # a non-tensor leaf (a cache tree's 0 for no groups)


def named(mesh, pspecs):
    """The placements tree of a spec tree on a ``DeviceMesh``."""
    return _map_specs(lambda s: placements_of(mesh, s), pspecs)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and len(x) > 0 and all(isinstance(p, Placement) for p in x)


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (no communication).
    Two mesh dims sharding one tensor dim split it in mesh order."""
    t = full
    for mdim, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(mdim)
            t = t.chunk(n, dim=pl.dim)[mesh.get_local_rank(mdim)]
    return t


def place(tree, mesh, placements):
    """DTensors of full tensors (the same on every rank) under a placements
    tree; every rank keeps its own slice."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        if not torch.is_tensor(t):
            return t
        local = local_slice(t, mesh, pl).contiguous()
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())

    return _zip_placements(one, tree, placements)


def _zip_placements(fn, tree, placements):
    if isinstance(tree, dict):
        return {k: _zip_placements(fn, tree[k], placements[k]) for k in tree}
    if _is_placements(placements):
        return fn(tree, placements)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_placements(fn, t, p) for t, p in zip(tree, placements))
    return tree


def wrap_like(local: torch.Tensor, like):
    """``local`` as a DTensor of ``like``'s mesh, placements, shape and stride."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def shard_like(full_t: torch.Tensor, like):
    """This rank's slice of the full tensor ``full_t`` as a DTensor placed
    like ``like`` (``full``'s inverse)."""
    return wrap_like(local_slice(full_t, like.device_mesh, like.placements).contiguous(), like)


def full(tree):
    """Full tensors of a tree of DTensors (an all-gather of every sharded
    leaf over its own mesh, recorded like every collective here); the
    inverse of ``local_slice``."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if not isinstance(t, DTensor):
            return t
        out, mesh = t.to_local(), t.device_mesh
        # local_slice splits in mesh order: gather the innermost split first
        for name, pl in reversed(list(zip(_names(mesh), t.placements))):
            if pl.is_shard():
                out = all_gather(out, name, pl.dim, mesh)
        return out

    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(full(v) for v in tree)
    return one(tree)


# ------------------------------------------------------ layout anchors (DTensor)


def _redistribute(x, spec):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x   # a per-rank local tensor is already in its code's layout
    return x.redistribute(x.device_mesh, placements_of(x.device_mesh, spec))


def constrain(x, *spec):
    if _ACTIVE["mesh"] is None:
        return x
    return _redistribute(x, tuple(spec))


def constrain_act(x):
    """Pin the residual stream to the Megatron activation layout: batch over
    the DP axes, features replicated.  The per-rank step's residual stream is
    its DP rows already, replicated over 'model'; a DTensor is redistributed
    to that layout."""
    if _ACTIVE["mesh"] is None or x.dim() not in (2, 3):
        return x
    return _redistribute(x, (_ACTIVE["dp"],) + (None,) * (x.dim() - 1))


def constrain_ep_weight(w):
    """Replicate an expert weight's non-E dims at use (experts stay on
    'model')."""
    if _ACTIVE["mesh"] is None or w.dim() != 3:
        return w
    spec_e = "model" if w.shape[0] % tp_size() == 0 else None
    return _redistribute(w, (spec_e, None, None))


def constrain_moe_buf(buf):
    """EP layout for the dispatch buffer (E, C, d): experts over 'model',
    capacity over the DP axes."""
    if _ACTIVE["mesh"] is None:
        return buf
    dp = _ACTIVE["dp"]
    spec_c = dp if buf.shape[1] % max(dp_size(), 1) == 0 else None
    spec_e = "model" if buf.shape[0] % tp_size() == 0 else None
    return _redistribute(buf, (spec_e, spec_c, None))


# ------------------------------------------------------------- collectives

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _record(kind: str, in_bytes: int, out_bytes: int, n: int):
    trace = _ACTIVE["trace"]
    if trace is not None:
        trace.append((kind, in_bytes, out_bytes, n))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(axis: str):
    return _ACTIVE["mesh"].get_group(axis)


def all_gather(t: torch.Tensor, axis: str, dim: int, mesh=None) -> torch.Tensor:
    """Concatenate the ranks' ``t`` along ``dim`` over ``axis`` of ``mesh``
    (the active mesh by default)."""
    mesh = mesh if mesh is not None else _ACTIVE["mesh"]
    n = mesh_sizes(mesh)[axis]
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _all_gather(out, src, group=mesh.get_group(axis))
    _record("all-gather", _nbytes(src), _nbytes(out), n)
    # in t's own layout: a matmul's kernel (and its rounding) can depend on it
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Sum ``t`` over ``axis`` and keep this rank's chunk along ``dim``."""
    n = size(axis)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _reduce_scatter(out, src, group=_group(axis))
    _record("reduce-scatter", _nbytes(src), _nbytes(out), n)
    return out.movedim(0, dim).contiguous()


def halves_to_channels(t: torch.Tensor, axis: str, dim: int,
                       inverse: bool = False) -> torch.Tensor:
    """A (.., [a | b], ..) leaf split over ``axis`` along ``dim`` (rank k
    holds units 2k, 2k+1 of the 2n units) -> this rank j's channels of
    both halves, units j and n + j, by one all-to-all (``inverse``: back)."""
    n = size(axis)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    u = src.shape[0] // 2
    k = coord(axis)
    units, channels = [0] * n, [0] * n
    units[(2 * k) % n] = units[(2 * k + 1) % n] = u       # where this rank's units go
    channels[k // 2] = channels[(n + k) // 2] = u         # where its channels come from
    send, recv = (channels, units) if inverse else (units, channels)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, recv, send, group=_group(axis))
    _record("all-to-all", _nbytes(src), _nbytes(out), n)
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axes`` (a name or a tuple of names; one
    all-reduce per axis), as a new tensor."""
    out = t.contiguous().clone()
    for axis in (axes if isinstance(axes, tuple) else (axes,)):
        dist.all_reduce(out, op=op, group=_group(axis))
        _record("all-reduce", _nbytes(out), _nbytes(out), size(axis))
    return out


def _dp_group():
    """The process group of this rank's DP ranks (one per coordinate of the
    other axes; built once a mesh when the DP axes are more than one)."""
    dp = _ACTIVE["dp"]
    if len(dp) == 1:
        return _group(dp[0])
    if _ACTIVE["dp_group"] is None:
        mesh = _ACTIVE["mesh"]
        names = _names(mesh)
        order = [names.index(a) for a in names if a not in dp] + [names.index(a) for a in dp]
        for ranks in mesh.mesh.permute(order).reshape(-1, size(dp)).tolist():
            g = dist.new_group(ranks)   # every rank creates every group, in order
            if dist.get_rank() in ranks:
                _ACTIVE["dp_group"] = g
    return _ACTIVE["dp_group"]


def regroup_rows(t: torch.Tensor, rows_of) -> torch.Tensor:
    """Rows of a leaf split over the DP axes (this rank holds block
    ``dp_index()`` of dim 0) -> the global rows ``rows_of(d)`` (ascending)
    on each DP rank d, in that order, by one all-to-all over the DP ranks."""
    n, s, L = dp_size(), dp_index(), t.shape[0]
    send = [[r - s * L for r in rows_of(d) if s * L <= r < (s + 1) * L] for d in range(n)]
    recv = [sum(1 for r in rows_of(s) if k * L <= r < (k + 1) * L) for k in range(n)]
    src = t.index_select(0, torch.tensor([j for rows in send for j in rows], device=t.device))
    out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
    dist.all_to_all_single(out, src, recv, [len(rows) for rows in send], group=_dp_group())
    _record("all-to-all", _nbytes(src), _nbytes(out), n)
    return out


def microbatch_parts(t: torch.Tensor, split_in: bool, split_out: bool,
                     microbatches: int) -> list:
    """This rank's part of each microbatch (rows i*mb .. (i+1)*mb of the
    global batch, the reference's static reshape) of a batch leaf: ``t``
    this rank's rows (``split_in``: its block over the DP axes, else all
    rows); each part its share over the DP axes (``split_out``) or the whole
    microbatch.  Rows move by one all-to-all over the DP ranks."""
    n = dp_size()
    B = t.shape[0] * (n if split_in else 1)
    mb = B // microbatches
    if split_out and mb % n:
        raise ValueError(f"a microbatch of {mb} rows does not split over {n} DP ranks")
    share = mb // n if split_out else mb

    def rows_of(d):
        off = d * share if split_out else 0
        return [i * mb + off + q for i in range(microbatches) for q in range(share)]

    if split_in:
        t = regroup_rows(t, rows_of)
    else:
        t = t.index_select(0, torch.tensor(rows_of(dp_index()), device=t.device))
    return list(t.split(share))


def chunk_of(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return t.chunk(size(axis), dim=dim)[coord(axis)]


class _Gather(torch.autograd.Function):
    """All-gather over ``axis`` along ``dim``; the backward reduce-scatters
    (``partial``: the ranks' gradients are parts of a sum) or keeps this
    rank's chunk (the ranks computed the same gradient)."""

    @staticmethod
    def forward(ctx, t, axis, dim, partial):
        ctx.axis, ctx.dim, ctx.partial = axis, dim, partial
        return all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return reduce_scatter(g, ctx.axis, ctx.dim), None, None, None
        return chunk_of(g, ctx.axis, ctx.dim).contiguous(), None, None, None


class _GradSum(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over ``axes`` (Megatron's
    f: the ranks' gradients are parts of a sum)."""

    @staticmethod
    def forward(ctx, t, axes):
        ctx.axes = axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes), None


class _Sum(torch.autograd.Function):
    """All-reduce forward over ``axes``, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, t, axes):
        return all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _HalvesToChannels(torch.autograd.Function):
    """``halves_to_channels``; the backward sends each gradient back."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return halves_to_channels(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return halves_to_channels(g, ctx.axis, ctx.dim, inverse=True), None, None


class _Chunk(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a tensor replicated over ``axis``;
    the backward gathers the chunks' gradients (each rank's covers its own
    chunk of the replicated leaf's gradient)."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return chunk_of(t, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


def enter_tp(x, on: bool = True):
    """Enter a region split over 'model' (x replicated over it)."""
    if _ACTIVE["mesh"] is None or not on:
        return x
    return _GradSum.apply(x, _ACTIVE["tp"])


def leave_tp(y, on: bool = True):
    """Leave a region split over 'model': sum the ranks' partial outputs."""
    if _ACTIVE["mesh"] is None or not on:
        return y
    return _Sum.apply(y, _ACTIVE["tp"])


def psum_tp(x, on: bool = True):
    """Partial sums over 'model' for compute split over 'model': all-reduce
    forward, and the gradient (each rank's use is a part) all-reduced."""
    if _ACTIVE["mesh"] is None or not on:
        return x
    return _GradSum.apply(_Sum.apply(x, _ACTIVE["tp"]), _ACTIVE["tp"])


def psum_dp(x):
    """A per-rank part of a sum over the DP axes: the forward sums it, the
    backward hands every rank the gradient of the sum (its part's)."""
    if _ACTIVE["mesh"] is None:
        return x
    return _Sum.apply(x, _ACTIVE["dp"])


# ------------------------------------------------------------- local shards


@dataclasses.dataclass
class Local:
    """One rank's shard of a leaf: ``t`` (autograd flows through it) and,
    per mesh axis, the tensor dim that axis shards (``None``: replicated)."""
    t: torch.Tensor
    dims: dict

    def _inner_dims(self) -> dict:
        return {a: (None if d is None else d - 1) for a, d in self.dims.items()}

    def unbind0(self) -> list["Local"]:
        """The slices along an unsharded leading dim (stacked groups)."""
        dims = self._inner_dims()
        return [Local(t, dims) for t in self.t.unbind(0)]

    def __getitem__(self, g: int) -> "Local":
        return Local(self.t[g], self._inner_dims())


def localize(tree):
    """DTensor leaves -> ``Local`` shards (through ``to_local``, so gradients
    reach the DTensors); plain tensors -> replicated ``Local``s."""
    from torch.distributed.tensor import DTensor

    names = _names(_ACTIVE["mesh"])

    def one(t):
        if isinstance(t, DTensor):
            dims = {a: (pl.dim if pl.is_shard() else None) for a, pl in zip(names, t.placements)}
            return Local(t.to_local(), dims)
        if torch.is_tensor(t):
            return Local(t, {a: None for a in names})
        return t

    if isinstance(tree, dict):
        return {k: localize(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(localize(v) for v in tree)
    return one(tree)


def use(w, tp=None, dp_split: bool = True) -> torch.Tensor:
    """A weight at use, as a plain tensor.

    The DP axes are gathered in full; their backward sums the ranks'
    gradients (``dp_split``: each rank ran its own batch rows) or keeps this
    rank's part (the ranks ran the same rows).  On 'model', ``tp=None``: the
    full weight for compute replicated over 'model' (the backward keeps this
    rank's chunk); ``tp=("local", i)``: this rank's chunk along dim ``i`` for
    compute split over 'model'; ``tp=("halves", i)``: this rank's chunk of
    each half of dim ``i`` (mamba's in_proj); ``tp="full"``: the full weight
    for compute split over 'model' (the backward sums the partial
    gradients)."""
    if not isinstance(w, Local):
        return w
    t = w.t
    tpa = _ACTIVE["tp"]
    for axis in _ACTIVE["dp"]:
        d = w.dims.get(axis)
        if d is not None:
            t = _Gather.apply(t, axis, d, dp_split)
        elif dp_split and torch.is_grad_enabled() and t.requires_grad:
            t = _GradSum.apply(t, axis)
    d = w.dims.get(tpa)
    if tp is None:
        if d is not None:
            t = _Gather.apply(t, tpa, d, False)
    elif tp == "full":
        if d is not None:
            t = _Gather.apply(t, tpa, d, True)
        elif torch.is_grad_enabled() and t.requires_grad:
            t = _GradSum.apply(t, tpa)
    elif tp[0] == "halves":
        i = tp[1]
        if d == i:
            t = _HalvesToChannels.apply(t, tpa, i)
        else:
            if d is not None:
                t = _Gather.apply(t, tpa, d, False)
            t = torch.cat([_Chunk.apply(h, tpa, i) for h in t.chunk(2, dim=i)], dim=i)
    else:
        _, i = tp
        if d is None:
            t = _Chunk.apply(t, tpa, i)
        elif d != i:
            # the chunk's backward gathers the whole gradient on every rank
            t = _Chunk.apply(_Gather.apply(t, tpa, d, False), tpa, i)
    return t


def use_tree(tree, tp=None, dp_split: bool = True):
    if isinstance(tree, dict):
        return {k: use_tree(v, tp, dp_split) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(use_tree(v, tp, dp_split) for v in tree)
    return use(tree, tp, dp_split)


# --------------------------------------------------------- the layer plans


def head_split(cfg) -> tuple[int, int, int] | None:
    """(query heads, first KV head, KV heads) of this rank when attention
    splits over 'model', else ``None``: the query heads must divide, and a
    rank's heads must cover whole KV groups or lie in one."""
    n = tp_size()
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    group = H // KVH
    if H % n:
        return None
    h_loc = H // n
    if h_loc % group and group % h_loc:
        return None
    j = coord(_ACTIVE["tp"])
    kv_lo = (j * h_loc) // group
    kv_hi = ((j + 1) * h_loc - 1) // group + 1
    return h_loc, kv_lo, kv_hi - kv_lo


def attn_local(p: dict, cfg, split) -> dict:
    """The attention weights a rank uses: its query heads' columns of wq and
    rows of wo, its KV heads' columns of wk, wv (``split`` from
    ``head_split``), or every head (``split`` None)."""
    if split is None:
        return use_tree(p)
    _, kv_lo, kvh = split
    dh = cfg.d_head
    out = {"wq": use(p["wq"], ("local", 1)), "wo": use(p["wo"], ("local", 0))}
    # a rank's own columns of wk, wv are its KV heads when the KV heads split
    kv_aligned = p["wk"].dims.get(_ACTIVE["tp"]) == 1 and cfg.n_kv_heads % tp_size() == 0
    for name in ("wk", "wv"):
        if kv_aligned:
            out[name] = use(p[name], ("local", 1))
        else:
            out[name] = use(p[name], "full")[:, kv_lo * dh:(kv_lo + kvh) * dh]
    return out


def channel_split(n: int) -> bool:
    """Whether a recurrent block's ``n`` channels (mamba's d_inner, rwkv's
    heads) split over 'model', as the reference's specs split its weights:
    under a mesh whose 'model' axis has an even number of ranks that
    divides ``n``; else the block runs replicated over 'model'."""
    if _ACTIVE["mesh"] is None:
        return False
    m = tp_size()
    return m > 1 and m % 2 == 0 and n % m == 0


_MAMBA_DIMS = {"in_proj": ("halves", 1), "conv_w": ("local", 1), "conv_b": ("local", 0),
               "w_dt1": ("local", 0), "w_dt2": ("local", 1), "dt_bias": ("local", 0),
               "w_B": ("local", 0), "w_C": ("local", 0), "A_log": ("local", 0),
               "D": ("local", 0), "out_proj": ("local", 0)}
# rwkv: the heads' columns of r, k, v, g and the decay, rows of w_o; the
# channel mix's columns of cm_k and rows of cm_v (its receptance replicated)
_RWKV_DIMS = {"w_r": ("local", 1), "w_k": ("local", 1), "w_v": ("local", 1),
              "w_g": ("local", 1), "w_o": ("local", 0), "w_decay_b": ("local", 1),
              "w_decay_base": ("local", 0), "u_bonus": ("local", 0), "ln_x": ("local", 0),
              "cm_k": ("local", 1), "cm_v": ("local", 0)}


def mamba_local(p: dict, split: bool) -> dict:
    """The mamba weights a rank uses: its chunk of the d_inner channels
    (``split``), or all of them."""
    if not split:
        return use_tree(p)
    return {k: use(v, _MAMBA_DIMS[k]) for k, v in p.items()}


def rwkv_local(p: dict, split: bool) -> dict:
    """The rwkv weights a rank uses: its heads' (``split``), or all."""
    if not split:
        return use_tree(p)
    return {k: use(v, _RWKV_DIMS.get(k)) for k, v in p.items()}


def _rows_or_tp_on(x, dim: int) -> bool:
    """Whether only the rows (dim 0), and at most 'model' on ``dim``, split
    the state ``x``."""
    tpa = _ACTIVE["tp"]
    return isinstance(x, Local) and all(d in (None, 0) or (a == tpa and d == dim)
                                        for a, d in x.dims.items())


def state_part(x, dim: int | None) -> torch.Tensor:
    """A recurrent state of this rank's rows: whole (``dim`` None), or this
    rank's chunk of dim ``dim`` over 'model'."""
    tpa = _ACTIVE["tp"]
    if dim is not None and _rows_or_tp_on(x, dim):
        return x.t if x.dims.get(tpa) == dim else chunk_of(x.t, tpa, dim)
    full = state_full(x)
    return full if dim is None else chunk_of(full, tpa, dim)


def state_put_part(x, new: torch.Tensor, dim: int | None) -> None:
    """Write ``new`` (as ``state_part`` gave it) into ``x`` (in place)."""
    tpa = _ACTIVE["tp"]
    if dim is not None and _rows_or_tp_on(x, dim) and x.dims.get(tpa) == dim:
        x.t.copy_(new)
        return
    state_put(x, new if dim is None else all_gather(new, tpa, dim))


def batch_local(tree):
    """A batch's leaves as this rank's rows: DTensors (``Shard(0)`` over the
    DP axes, or replicated when the batch does not split) -> their local
    tensors.  Returns (the local tree, whether the rows split over the DP
    axes); plain tensors under a mesh are this rank's own rows."""
    from torch.distributed.tensor import DTensor

    leaves = [t for t in (tree.values() if isinstance(tree, dict) else [tree])
              if isinstance(t, DTensor)]
    split = not leaves or any(pl.is_shard() for pl in leaves[0].placements)
    if isinstance(tree, dict):
        return {k: (v.to_local() if isinstance(v, DTensor) else v) for k, v in tree.items()}, split
    return (tree.to_local() if isinstance(tree, DTensor) else tree), split


def batch_placements(mesh, rows: int, ndim: int) -> tuple:
    """Placements of a batch leaf of ``rows`` rows: rows over the DP axes
    when they divide, else replicated."""
    dp = _ACTIVE["dp"]
    n = math.prod(mesh_sizes(mesh)[a] for a in dp)
    lead = dp if rows % n == 0 and rows >= n else None
    return placements_of(mesh, (lead,) + (None,) * (ndim - 1))


# ----------------------------------------------------------------- norms


def global_sq_sum(leaves) -> torch.Tensor:
    """Sum of squares over DTensor leaves (fp32), each counted once: every
    rank's local sum weighted by 1 / (its replication), summed over all
    ranks.  Returns a plain 0-d tensor on the leaves' device."""
    from torch.distributed.tensor import DTensor

    total = None
    for x in leaves:
        local = x.to_local() if isinstance(x, DTensor) else x
        rep = 1
        if isinstance(x, DTensor):
            rep = math.prod(x.device_mesh.size(i) for i, pl in enumerate(x.placements)
                            if not pl.is_shard())
        s = torch.sum(torch.square(local.float())) / rep
        total = s if total is None else total + s
    out = total.clone()
    dist.all_reduce(out)
    _record("all-reduce", _nbytes(out), _nbytes(out), dist.get_world_size())
    return out


# ------------------------------------------------------------------ decode


def global_dim(w, i: int) -> int:
    """The global size of dim ``i`` of a weight (a ``Local`` or a tensor)."""
    if not isinstance(w, Local):
        return w.shape[i]
    return w.t.shape[i] * math.prod(size(a) for a, d in w.dims.items() if d == i)


def local_t(x) -> torch.Tensor:
    return x.t if isinstance(x, Local) else x


def seq_split(x, dim: int) -> tuple[tuple[str, ...], int]:
    """(the axes of more than one rank that split dim ``dim`` of a cache
    leaf, in mesh order; this rank's offset along it)."""
    if not isinstance(x, Local):
        return (), 0
    axes = tuple(a for a in _names(_ACTIVE["mesh"]) if x.dims.get(a) == dim and size(a) > 1)
    idx = 0
    for a in axes:
        idx = idx * size(a) + coord(a)
    return axes, idx * x.t.shape[dim]


def decode_attention(q, k, v, context_len: int, lo: int, axes) -> torch.Tensor:
    """``layers.decode_attention`` over a KV cache whose sequence is split
    over ``axes``: this rank holds positions ``lo ..``; the softmax's max and
    sum and the output are combined over the ranks (fp32)."""
    from repro_torch.models.layers import NEG_INF

    B, H, Dh = q.shape
    KVH, S = k.shape[1], k.shape[2]
    group = H // KVH
    qg = (q.float() * Dh**-0.5).reshape(B, KVH, group, Dh)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float()).reshape(B, H, S)
    pos = lo + torch.arange(S, device=q.device)[None, :]
    logits = torch.where((pos < context_len)[:, None, :], logits, NEG_INF)
    m = all_reduce(logits.amax(dim=-1, keepdim=True), axes, dist.ReduceOp.MAX)
    p = torch.exp(logits - m)
    p = p / all_reduce(p.sum(dim=-1, keepdim=True), axes)
    out = torch.einsum("bkgs,bksd->bkgd", p.reshape(B, KVH, group, S), v.float())
    return all_reduce(out, axes).reshape(B, H, Dh).to(q.dtype)


def state_full(x) -> torch.Tensor:
    """A recurrent state's rows of this rank, gathered over the axes that
    split its other dims."""
    if not isinstance(x, Local):
        return x
    t = x.t
    for a in _names(_ACTIVE["mesh"]):
        d = x.dims.get(a)
        if d not in (None, 0):
            t = all_gather(t, a, d)
    return t


def state_put(x, new: torch.Tensor, batch_dim: int = 0) -> None:
    """Write this rank's part of a full new state into ``x`` (in place)."""
    if not isinstance(x, Local):
        x.copy_(new)
        return
    for a in _names(_ACTIVE["mesh"]):
        d = x.dims.get(a)
        if d not in (None, batch_dim):
            new = chunk_of(new, a, d)
    x.t.copy_(new)


def kv_full(k: torch.Tensor, cfg, dim: int = 1) -> torch.Tensor:
    """A prefill K or V of this rank's KV heads (on dim ``dim``) -> every KV
    head, gathered over 'model' (identity when heads do not split)."""
    split = head_split(cfg)
    if split is None:
        return k
    tpa = _ACTIVE["tp"]
    h_loc, _, kvh = split
    group = cfg.n_heads // cfg.n_kv_heads
    gathered = all_gather(k.contiguous(), tpa, dim)
    idx = []
    for h in range(cfg.n_kv_heads):
        j = (h * group) // h_loc            # the first rank holding KV head h
        idx.append(j * kvh + h - (j * h_loc) // group)
    return gathered.index_select(dim, torch.tensor(idx, device=k.device))
