"""Launch wrappers for the CUDA ``binary_ip`` kernel (``csrc/binary_ip.cu``).

The kernel replaces the Pallas TPU kernel ``_binary_ip_kernel`` and, through
``estimate_dist2_cuda``, the XLA epilogue the reference fuses around it: the
whole RaBitQ level-1 estimate is one launch, with no PyTorch op before or
after it.  Two paths (see the source): several lanes a code row on the CUDA
cores for the search path's small calls, and ``mma.sync`` on the tensor
cores (fp32 queries as three exact bf16 terms) for sweeps of many rows.  At
the search path's shape a call is latency, so the wrappers check each
tensor in one pass of plain attributes (``get_device`` gives an int, no
``torch.device`` is built), take the raw stream from ``_build.stream``,
allocate the output with ``torch.empty`` and launch on the current stream
without synchronising.  Both entries count in ``launches``, and the calls
that took the tensor-core path also in ``tensor_core_launches``; with
``repro_torch.tracing`` on, each call is a ``kernels.launch`` span.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

launches = 0  # kernel launches of either entry since the caller last set it to 0
tensor_core_launches = 0  # of those, the ones on the tensor-core path

# Calls of two queries or more over at least this many rows take the
# tensor-core path (where d % 32 == 0 and the codes are 4-byte aligned);
# others the lanes path.  Measured on an H100 (PERF.md section 6): at B = 8,
# d = 128 the tensor cores are faster from 8 192 rows (3.4 against 4.0 us
# on the device) and 3x faster at 1M; at B = 1, where they multiply one
# query padded to eight, they are ahead by at most 1 us between 16K and 64K
# rows and behind at 1M (23.9 against 21.7 us), so one query stays on the
# lanes path.
TENSOR_CORE_MIN_ROWS = 8192

_F32, _BF16, _U8, _I64 = torch.float32, torch.bfloat16, torch.uint8, torch.int64
_LAUNCH = tracing.name("kernels.launch")  # checks, output allocation, the launch


def tensor_core_path(B: int, N: int, d: int, codes_ptr: int,
                     tensor_cores: bool | None = None) -> bool:
    """Whether a call of B queries over N code rows of width d takes the
    tensor-core path.  ``tensor_cores`` None picks by B and N; True asks for
    it and raises where d or the codes' alignment rule it out; False asks
    for the lanes path."""
    fits = d % 32 == 0 and codes_ptr % 4 == 0
    if tensor_cores is None:
        return fits and B >= 2 and N >= TENSOR_CORE_MIN_ROWS
    if tensor_cores and not fits:
        raise ValueError(f"binary_ip: the tensor-core path needs d % 32 == 0 and 4-byte aligned "
                         f"codes, got d={d}")
    return bool(tensor_cores)


def _refuse(name: str, t: torch.Tensor, what: str, ndim: int, index: int) -> ValueError:
    where = "a CUDA device" if index < 0 else f"cuda:{index}"
    return ValueError(f"binary_ip: {name} must be a contiguous {ndim}-d {what} tensor on "
                      f"{where}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _checked(q, codes, ids, tables) -> tuple[int, int, int, int, int]:
    """(device index, B, d, T, N) of a call, or ValueError for what the
    kernel does not take."""
    index = q.get_device()  # -1 on the CPU
    qt = q.dtype
    if qt is not _F32 and qt is not _BF16:
        raise _refuse("q", q, "float32 or bfloat16", 2, index)
    for name, t, dtype, ndim in (("q", q, qt, 2), ("codes", codes, _U8, 2),
                                 ("ids", ids, _I64, 1), *tables):
        if t is not None and (index < 0 or t.get_device() != index or t.dtype is not dtype
                              or t.dim() != ndim or not t.is_contiguous()):
            raise _refuse(name, t, str(dtype), ndim, index)
    B, d = q.shape
    T, row = codes.shape
    if d % 8 or row * 8 != d:
        raise ValueError(f"binary_ip: d={d} must be a multiple of 8 and "
                         f"codes must be (T, d/8), got {tuple(codes.shape)}")
    for name, t, _, _ in tables:
        if t.shape[0] != T:
            raise ValueError(f"binary_ip: {name} must have one entry per code row")
    return index, B, d, T, T if ids is None else ids.shape[0]


def binary_ip_cuda(
    q: torch.Tensor,                    # (B, d) float32 or bfloat16
    codes: torch.Tensor,                # (T, d/8) uint8
    ids: torch.Tensor | None = None,    # (N,) int64 rows of codes, or None
    *, tensor_cores: bool | None = None,
) -> torch.Tensor:
    """(B, N) float32 <q_b, sign(codes[ids[n]])> on the card (N = T when
    ``ids`` is None).  An id outside ``[0, T)`` yields NaN in its column.
    ``tensor_cores`` as in ``tensor_core_path``."""
    global launches, tensor_core_launches
    sp = tracing.begin(_LAUNCH) if tracing.on else -1
    index, B, d, T, N = _checked(q, codes, ids, ())
    codes_ptr = codes.data_ptr()
    tc = tensor_core_path(B, N, d, codes_ptr, tensor_cores)
    out = torch.empty((B, N), dtype=_F32, device=index)
    if B == 0 or N == 0:
        if sp >= 0:
            tracing.end(sp)
        return out
    lib = _build.load()
    err = (lib.binary_ip_f32 if q.dtype is _F32 else lib.binary_ip_bf16)(
        q.data_ptr(), codes_ptr, None if ids is None else ids.data_ptr(), out.data_ptr(),
        B, N, d, T, tc, index, _build.stream(index),
    )
    if err:
        _build.check("binary_ip", err)
    launches += 1
    tensor_core_launches += tc
    if sp >= 0:
        tracing.end(sp)
    return out


def estimate_dist2_cuda(
    q: torch.Tensor,                    # (B, d) float32 or bfloat16
    codes: torch.Tensor,                # (T, d/8) uint8
    norms: torch.Tensor,                # (T,) float32
    ip_bar: torch.Tensor,               # (T,) float32
    ids: torch.Tensor | None = None,    # (N,) int64 rows of the tables, or None
    *, tensor_cores: bool | None = None,
) -> torch.Tensor:
    """(B, N) float32 RaBitQ level-1 estimate ``estimate_dist2_ref(q,
    codes[ids], norms[ids], ip_bar[ids])`` on the card, in one launch.  An
    id outside ``[0, T)`` yields NaN in its column.  ``tensor_cores`` as in
    ``tensor_core_path``."""
    global launches, tensor_core_launches
    sp = tracing.begin(_LAUNCH) if tracing.on else -1
    index, B, d, T, N = _checked(q, codes, ids, (("norms", norms, _F32, 1),
                                                 ("ip_bar", ip_bar, _F32, 1)))
    codes_ptr = codes.data_ptr()
    tc = tensor_core_path(B, N, d, codes_ptr, tensor_cores)
    out = torch.empty((B, N), dtype=_F32, device=index)
    if B == 0 or N == 0:
        if sp >= 0:
            tracing.end(sp)
        return out
    lib = _build.load()
    err = (lib.binary_est_f32 if q.dtype is _F32 else lib.binary_est_bf16)(
        q.data_ptr(), codes_ptr, norms.data_ptr(), ip_bar.data_ptr(),
        None if ids is None else ids.data_ptr(), out.data_ptr(),
        B, N, d, T, tc, index, _build.stream(index),
    )
    if err:
        _build.check("binary_ip", err)
    launches += 1
    tensor_core_launches += tc
    if sp >= 0:
        tracing.end(sp)
    return out
