"""Build the CUDA kernels and load them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` (all started together; the ``*.cuh`` headers beside them are
included, not compiled), and the objects are linked into one shared
library with a plain C interface, ``build/kernels/librepro_torch_kernels.so``
at the root of the checkout.  The build runs at first use in a process and is
skipped when a stamp of the sources and flags matches the library on disk.
Nothing here runs at import time: this module imports on hosts with no
``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# q, k_pages, v_pages, block_tables, context_lens, out, part, B, H, KVH,
# head_chunks, Dh, page, max_pages, n_pages, split_tokens, n_split, scale,
# device, stream
_PAGED = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I64, _I, _I, _F, _I, _P)
# q, k, v, out, B, H, KVH, Sq, Skv, Dh, causal, has_window, window, scale, device, stream
_FLASH = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P)
# C entry -> argtypes; every entry returns its launch's cudaError_t as int
SIGNATURES = {
    # q, codes, ids, out, B, N, d, n_table, tensor_cores, device, stream
    "binary_ip_f32": (_P, _P, _P, _P, _I, _I, _I, _I64, _I, _I, _P),
    "binary_ip_bf16": (_P, _P, _P, _P, _I, _I, _I, _I64, _I, _I, _P),
    # q, codes, norms, ip_bar, ids, out, B, N, d, n_table, tensor_cores, device, stream
    "binary_est_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _I, _I, _P),
    "binary_est_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _I, _I, _P),
    # q, codes, lo, step, ids, out, B, N, d, n_table, device, stream
    "int4_dist_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _I, _P),
    # g, qtab, rtab, ipb, carry_vals, carry_ids, out_vals, out_ids, full_rows, B, L, C, row0,
    # inv, device, stream
    "scan_select_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _F, _I, _P),
    "scan_select_ip_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _F, _I, _P),
    "paged_attention_f32": _PAGED,
    "paged_attention_bf16": _PAGED,
    "flash_attention_f32": _FLASH,
    "flash_attention_bf16": _FLASH,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (with -Xptxas -v) from the last build in this process


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            path = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stamp(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(CSRC.glob("*.cuh"))]:  # the sources and the headers they share
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile and link the kernel library unless the stamp on disk matches.
    Raises ``RuntimeError`` with nvcc's output when a source fails."""
    global build_log
    srcs = sources()
    lib = BUILD_DIR / LIB_NAME
    stamp_file = BUILD_DIR / (LIB_NAME + ".sha256")
    stamp = _stamp(srcs)
    if lib.exists() and stamp_file.exists() and stamp_file.read_text() == stamp:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o", str(obj)]
        jobs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for s, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {s.name}\n{out}")
        if proc.returncode != 0:
            failed.append(s.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in jobs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp_file.write_text(stamp)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every entry's
    argtypes and restype declared."""
    global _lib
    if _lib is not None:  # the launch path: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def loaded() -> bool:
    return _lib is not None


def stream(device) -> int:
    """The raw CUDA stream PyTorch launches on for ``device`` (a CUDA
    ``torch.device`` or its index), as an int for a C entry, read without
    building a ``torch.cuda.Stream`` object on every call."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device if isinstance(device, int) else device.index)


def check(name: str, err: int) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
