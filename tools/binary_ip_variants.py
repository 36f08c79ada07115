#!/usr/bin/env python3
"""Where binary_ip's time goes on the card: variants of its source, and where
each of its two paths wins.

    python3 tools/binary_ip_variants.py [OUT.json]

Builds the checkout's kernel library and, beside it, variants of
``csrc/binary_ip.cu`` made by text substitution, each compiled by its own
``nvcc -shared`` (in parallel) and called through ctypes on the same
tensors.  Prints device microseconds a call (the CUDA profiler, 30 calls)
for:

* each variant at the sweep (8 x 1M x 128, fp32 and bf16 queries, and one
  query) on the tensor-core path, and at the search path's flush (8 x 256
  ids into 1M rows) on the lanes path, both entries.  Variants marked
  ``timing only`` take a part of the kernel away (the sign unpack, the
  products, the stores) and give wrong results on purpose: what they save
  is what that part costs.  The others compute the same function and are
  checked against the plain version;
* the built library's sweep through ids (``ids = arange(N)``, the gathered
  instantiation) beside the sweep without;
* both paths over N at B = 1 and 8 (the crossover behind
  ``kernel.py::TENSOR_CORE_MIN_ROWS``);
* the tensor-core kernel's SASS: instructions by opcode in the fp32 sweep
  instantiation, as built and with the three-instruction unpack.

Writes everything, with the card line, to OUT.json when given.  Needs one
CUDA card and nvcc; a minute or two.
"""

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.binary_ip import kernel as bip_kernel  # noqa: E402
from repro_torch.kernels.binary_ip import ref as bip_ref  # noqa: E402

SRC = _build.CSRC / "binary_ip.cu"
OUT = _build.BUILD_DIR / "variants"
UNPACK = """          a[i][0] = sign_pair(w[i][0], 2 * s, neg1);      // k slots 2t, 2t + 1 of row g
          a[i][1] = sign_pair(w[i][1], 2 * s, neg1);      // the same of row g + 8
          a[i][2] = sign_pair(w[i][0], 2 * s + 1, neg1);  // k slots 2t + 8, 2t + 9
          a[i][3] = sign_pair(w[i][1], 2 * s + 1, neg1);"""
NO_UNPACK = ("          a[i][0] = w[i][0]; a[i][1] = w[i][1]; a[i][2] = w[i][0] ^ s; "
             "a[i][3] = w[i][1] ^ s;")
SIGN_PAIR_BODY = """  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(w & (0x00010001u << p)), "r"(0u - (1u << (15 - p))), "r"(bf16_neg1));
  return r;"""
XOR_BODY = "  return ((w << (15 - p)) & 0x80008000u) ^ 0xBF80BF80u;"
LOOP = "  for (; tile < tiles; tile += tstride) {\n"
PREFETCH = ("    const TileLoad<EST> nxt = fetch_tile<EST, IDS>(tile + tstride, N, ids, codes, "
            "norms, ip_bar, n_table, words, g, t);\n")
NEXT_TILE = """    if (tile + tstride < tiles)
      cur = fetch_tile<EST, IDS>(tile + tstride, N, ids, codes, norms, ip_bar, n_table, words, g,
                                 t);"""
MMA = "for (int i = 0; i < kMT; ++i) mma_bf16_16816(term == 0 ? hi[i] : lo[i], a[i], f0, f1);"
NO_MMA = ("for (int i = 0; i < kMT; ++i) (term == 0 ? hi[i] : lo[i])[0] += "
          "__uint_as_float(a[i][0] ^ f0 ^ a[i][3] ^ f1);")
STORE = "          *reinterpret_cast<float4*>(o) = v;"
QNORM = "    const float my_qn = sqrtf(s), my_sc = est_scale(my_qn, d);"
GATHER = "      r.x = norms[src];\n      r.ib = ip_bar[src];"
# name -> (substitutions, computes the same function)
VARIANTS = {
    "as built": ([], True),
    "xor unpack (3 instructions a register)": ([(SIGN_PAIR_BODY, XOR_BODY)], True),
    "prefetch a tile ahead": ([(LOOP, LOOP + PREFETCH), (NEXT_TILE, "    cur = nxt;")], True),
    "division in the estimate": ([("  float c = ip * sc * rib;",
                                   "  float c = (ip * sc) / (1.f / rib);")], True),
    "no unpack (timing only)": ([(UNPACK, NO_UNPACK)], False),
    "no products (timing only)": ([(MMA, NO_MMA)], False),
    "no stores (timing only)": ([(STORE, "          if (v.x == 12345.f) " + STORE.strip())],
                                False),
    "no query norm (timing only)": ([(QNORM, "    const float my_qn = 1.f + s * 0.f, my_sc = 1.f;"),
                                     ("    lane_sum(qp, 32);\n", "")], False),
    "no norm gathers (timing only)": ([(GATHER, "      r.x = 1.f;\n      r.ib = 0.5f;")], False),
}
ENTRIES = ("binary_ip_f32", "binary_ip_bf16", "binary_est_f32", "binary_est_bf16")


def build_variants() -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    nvcc = _build._nvcc()
    procs = {}
    for k, (name, (subs, _)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its substitution no longer applies")
            text = text.replace(old, new)
        (OUT / f"v{k}.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", str(OUT / f"v{k}.cu"),
               "-o", str(OUT / f"v{k}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for k, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} does not build:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"v{k}.so"))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = list(_build.SIGNATURES[entry])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_us(fn, reps: int = 30) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if "binary" in e.key)
    return round(total / reps, 3)


def sass_mix(lib: Path, instantiation: str) -> dict[str, int]:
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    ops: collections.Counter = collections.Counter()
    for fn in re.split(r"\n\s*Function : ", sass):
        if instantiation in fn.split("\n", 1)[0]:
            for line in fn.splitlines():
                m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
                if m:
                    ops[m.group(1)] += 1
    return dict(total=sum(ops.values()), **dict(ops.most_common(8)))


def main() -> int:
    if not torch.cuda.is_available():
        print("binary_ip_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    _build.load()
    libs = build_variants()
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    T, d = 1_000_000, 128
    codes = torch.randint(0, 256, (T, d // 8), generator=g, device=dev, dtype=torch.uint8)
    norms = torch.rand(T, generator=g, device=dev) * 2 + 0.25
    ip_bar = torch.rand(T, generator=g, device=dev) * 0.9 + 0.05
    flush_ids = torch.randint(0, T, (256,), generator=g, device=dev)
    res = dict(card=card, variants={}, sweep_through_ids={}, crossover=[], sass={})
    # (label, B, dtype, ids, tensor cores)
    cases = [("sweep 8 x 1M fp32", 8, torch.float32, None, 1),
             ("sweep 8 x 1M bf16", 8, torch.bfloat16, None, 1),
             ("sweep 1 x 1M fp32", 1, torch.float32, None, 1),
             ("flush 8 x 256 fp32", 8, torch.float32, flush_ids, 0)]
    print(f"binary_ip variants, device us a call, on {card}:")
    for name, lib in libs.items():
        same = VARIANTS[name][1]
        row = {}
        for label, B, dtype, ids, tc in cases:
            q = torch.randn(B, d, generator=g, device=dev).to(dtype)
            N = T if ids is None else ids.shape[0]
            out = torch.empty(B, N, device=dev)
            rows = (codes, norms, ip_bar) if ids is None else (codes[ids], norms[ids], ip_bar[ids])
            suffix = "f32" if dtype is torch.float32 else "bf16"
            ip_fn = getattr(lib, "binary_ip_" + suffix)
            est_fn = getattr(lib, "binary_est_" + suffix)
            id_ptr = None if ids is None else ids.data_ptr()
            calls = {
                "binary_ip": lambda: ip_fn(q.data_ptr(), codes.data_ptr(), id_ptr, out.data_ptr(),
                                           B, N, d, T, tc, dev.index, stream),
                "estimate": lambda: est_fn(q.data_ptr(), codes.data_ptr(), norms.data_ptr(),
                                           ip_bar.data_ptr(), id_ptr, out.data_ptr(), B, N, d, T,
                                           tc, dev.index, stream),
            }
            for entry, call in calls.items():
                if call() != 0:
                    raise RuntimeError(f"variant {name!r} failed to launch")
                if same:
                    want = (bip_ref.binary_ip_ref(q, rows[0]) if entry == "binary_ip"
                            else bip_ref.estimate_dist2_ref(q, *rows))
                    torch.cuda.synchronize()
                    if not torch.allclose(out, want, rtol=1e-5, atol=1e-4):
                        raise RuntimeError(f"variant {name!r} disagrees at {label} {entry}")
                row[f"{label} {entry}"] = device_us(call)
        res["variants"][name] = row
        print(f"  {name:42s} " + "  ".join(f"{k}: {v:7.2f}" for k, v in row.items()))
    for B in (8, 1):
        q = torch.randn(B, d, generator=g, device=dev)
        iota = torch.arange(T, device=dev)
        res["sweep_through_ids"][f"B={B}"] = dict(
            no_ids=device_us(lambda: bip_kernel.binary_ip_cuda(q, codes, tensor_cores=True)),
            ids=device_us(lambda: bip_kernel.binary_ip_cuda(q, codes, iota, tensor_cores=True)))
    print("  sweep through ids (arange) vs none:", json.dumps(res["sweep_through_ids"]))
    for B in (1, 8):
        q = torch.randn(B, d, generator=g, device=dev)
        for N in (4096, 8192, 16384, 65536, 1_000_000):
            row = dict(B=B, N=N)
            for tc, path in ((False, "lanes"), (True, "tensor cores")):
                row[path] = device_us(
                    lambda: bip_kernel.binary_ip_cuda(q, codes[:N], tensor_cores=tc))
            res["crossover"].append(row)
            print("  crossover:", json.dumps(row))
    inst = "binary_mma_kernelILi3ELb0ELb0EfE"  # fp32 queries, sign product, no ids
    res["sass"]["as built"] = sass_mix(_build.BUILD_DIR / _build.LIB_NAME, inst)
    res["sass"]["xor unpack"] = sass_mix(OUT / "v1.so", inst)
    print("  sass of the fp32 sweep kernel:", json.dumps(res["sass"]))
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
