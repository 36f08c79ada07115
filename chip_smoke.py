#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of VeloANN, its KV serving plane and its LM stack.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --example quickstart_torch   # one twin, as phase 13 runs it

Phases (each one that fails ends the run with a non-zero exit):
  1. device   require CUDA, print the card's name and power limit, turn TF32 off
  2. build    compile src/repro_torch/csrc/*.cu for sm_90a (one nvcc each, in
              parallel) into build/kernels/librepro_torch_kernels.so
  3. kernels  each CUDA kernel against its plain PyTorch version on the card:
              binary_ip (the sign product and the fused RaBitQ estimate, fp32
              and bf16 queries) / int4_dist at the search path's shapes and at
              SIFT1M scale, sweeps of a 1M table on the tensor-core path
              (which must show HMMA in cuobjdump -sass); paged_attention at
              Yi-6B widths (B x context sweep, bf16 and fp32 pages);
              flash_attention at Yi-6B prefill, TinyLlama-1.1B's training
              call, a gemma3-1b local layer and whisper-small's encoder,
              bf16 and fp32 inputs;
              both at the reduced Yi-6B config's Dh 16, and paged decode at
              granite-20b's group of 48 heads over Dh 128; binary_ip's bf16
              sweeps at scan_search's chunk and tail (B 8 and 64);
              scan_select (the scan's stage-1 chunk epilogue) at B 4096 x
              32 768 rows, first and mid-scan, B 8 and 64, and the tail,
              bit for bit against the plain chain
              (fp32 rows bounded at the TF32 peak, the fp32 peak beside it;
              the fp32 and bf16 kernels must show tensor-core instructions
              in cuobjdump -sass).  Max error, kernel,
              plain and library-yardstick times (CUDA events, median of 30),
              and the least time the card could take (the bound)
  4. tables   a 1M x 128 index registered once in the torch distance engine;
              fused estimate / refine / beam-step calls held against the NumPy
              batch engine on the same ids; a profiled estimate_many call must
              run exactly one CUDA kernel (the fused estimate)
  5. search   VeloANN's search path end to end (build_system("velo") + run) on
              a 10 000 x 128 index, torch engine on the card with fuse on and
              device_beam off/on, against the batch engine on the same index;
              the kernels' launch counters are set to 0 before each torch run
              and read after it
  6. serving plane  the multi-tenant ServingPlane on phase 5's index (one
              combined table on the torch engine): a 1-tenant plane equals the
              isolated system, a 2-tenant static partition two isolated
              systems, velo at S = 1 equals unsharded and S = 2 keeps recall
              within 0.01, scheduler="rr" with a deadline plan equals the
              plan-free run
  7. velo device  the device search plane: batch_search (lockstep beam) and
              scan_search (binary_ip tensor-core stage 1 and scan_select's
              running top-C, int4 rerank) on phase 5's index against the port
              on the CPU, scan_search over phase 4's 1M table (31 binary_ip
              and 31 scan_select launches a scan, each binary_ip held against
              binary_ip_ref on the scan's own queries and chunk) against
              use_kernel=False, ids and distances equal, the full selects
              counted and 10 calls timed; batch_search must
              take the CPU's steps for every query and its top-10 ids for
              99 % of them; recall@10 against exact top-10 (an fp32 matmul),
              CUDA-event times, a profiled kernel split
  8. kv serve the paged KV serving plane end to end, twice: a PagedKVPool of
              bf16 pages at Yi-6B widths on the card, a CacheAwareScheduler
              over 48 seeded requests, one paged_attention launch per decode
              step (tables from PagedKVPool.batch_block_tables); 1 024 pages,
              oversubscribed (clock eviction and swap-in), then 60 000 pages,
              one layer's share of the card, which the traffic fits
  9. verify   the protocol verifier and the serve CLI on phase 5's index:
              velo with the HBM tier (device_beam off and on) and a 2-tenant
              plane (shared pool, quotas, the tier) run with
              verify_protocol on must equal their unverified runs with no
              violation; the schedule explorer at the JAX package's fixture
              (five algorithms + the pure-EDF plane, 5 schedules) and at
              full width (velo, 50 queries, seeds 0-1, unfused and fused)
              must be schedule-invariant with ties permuted, and reports
              the calls on binary_ip's tensor-core path;
              ``repro_torch.launch.serve`` at 2 000 x 128 must reach
              recall@10 0.6 with both distance kernels launched
 10. lm serve the port's LM serving path (configs, models): the reduced Yi-6B
              config, prefill plus 8 greedy decode steps on the card against
              the port on the CPU on the same weights (fp32 and bf16: tokens
              identical, logits within LM_TOL), then Yi-6B at full width in
              bf16 serving 4 requests of 2 048 prompt tokens: prefill (32
              flash_attention launches, each held against attention_ref on
              its own inputs), 16 greedy decode steps each retrieving top-5
              from phase 5's index through velo.batch_search; reports
              decode-continues-prefill, prefill / decode / retrieval times,
              flash's share of the prefill's device time, peak memory
 11. lm train the port's training path (train/*, launch/train): the reduced
              TinyLlama, 5 steps on the card against the port on the CPU on
              the same weights and batches, for AdamW, adamw8 and AdamW with
              the int8 gradient compression (fp32 and bf16: losses within
              TRAIN_LOSS_TOL, parameters within Adam's worst case and the
              bulk within the stated bars); adamw8 on the card beside the
              CPU's update fed the card's gradients (codes equal but for
              0.1 % off by one, CODE_BAR; the gradients' distance and the
              codes it moves reported); adamw8's update and the compression
              on one seeded gradient, card against CPU (adamw8's codes to
              CODE_BAR, the compression bitwise); then
              TinyLlama-1.1B at full width in bf16, 10 AdamW steps and 3
              adamw8 steps of 4 x 2 048 tokens: 44 flash_attention launches
              a step (forward and remat recompute of 22 layers; the first
              step's each held against attention_ref), a falling finite
              loss, step ms and tokens/s, peak memory, a profiled step's
              device split (GEMMs, flash, the plain attention backward, the
              optimizer and its share); then the training CLI resumed after
              an injected failure (exit 42) against an uninterrupted run
 12. lm shard the mesh (models.sharding, launch.mesh) in a one-rank NCCL group
              on the card, (data 1, model 1): Yi-6B at full width served
              with params placed by param_pspecs and caches by cache_pspecs
              (tokens equal to phase 10's, 32 flash launches a prefill);
              TinyLlama-1.1B at full width, 3 steps of 2 microbatches
              through the sharded step (grad_pspecs, batch_shardings, the
              state placed by opt_state_placements) against the unsharded
              step, for AdamW, adamw8 and AdamW with the int8 gradient
              compression (44 flash launches a microbatch; losses and
              parameters bitwise, else phase 11's bars); one dbrx-132b MoE
              layer at full width (16 experts top-4, 4 096 tokens) through
              moe_ffn_ep against moe_ffn (equal); the dry run's prediction
              for phase 11's batch at the 1 x 1 mesh beside phase 11's
              measured peak, step time and MFU, and the reference's test
              cell (rwkv6-7b long_500k pod1) on 256 fake ranks in a child
              process
 13. examples the torch twins of examples/{quickstart,serve_batch,
              distributed_search}.py, each its own process on the card
              (``chip_smoke.py --example NAME``; the last one's process
              group a one-rank NCCL group): each must exit 0 and print OK,
              launch its kernels (binary_ip and int4_dist; the scan
              binary_ip), counted from 0 around its main path, and the
              first calls of each kernel entry, kept, must agree with the
              plain versions at the twin's own d=64 shapes; recall, launches
              and wall seconds
 14. report   one JSON line of per-kernel numbers, then the card line and the
              final {"ok": true, ...} line

Imports torch, numpy and the port (src/repro_torch) only.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.nn.functional import scaled_dot_product_attention as sdpa

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.analysis import explore  # noqa: E402
from repro_torch.core import baselines, dataset, distance, serving, vamana, workload  # noqa: E402
from repro_torch.core import beam as beam_mod  # noqa: E402
from repro_torch.core.scheduling import SlaPlan  # noqa: E402
from repro_torch.core.quant import RabitQuantizer  # noqa: E402
from repro_torch.device import kernels_built  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.binary_ip import kernel as bip_kernel  # noqa: E402
from repro_torch.kernels.binary_ip import ops as bip_ops  # noqa: E402
from repro_torch.kernels.binary_ip import ref as bip_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.int4_dist import kernel as i4_kernel  # noqa: E402
from repro_torch.kernels.int4_dist import ops as i4_ops  # noqa: E402
from repro_torch.kernels.int4_dist import ref as i4_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.scan_select import kernel as sel_kernel  # noqa: E402
from repro_torch.kernels.scan_select import ref as sel_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.serving.kv_pool import PagedKVPool  # noqa: E402
from repro_torch.train import data as train_data  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.serving.scheduler import CacheAwareScheduler, ServeRequest  # noqa: E402
from repro_torch.velo import batch_search, scan_search  # noqa: E402
from repro_torch.velo import index as velo_index  # noqa: E402

# H100 SXM data-sheet peaks: HBM3 bytes/s, fp32 (non-tensor), TF32 and bf16
# (dense tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# the peak of the units each kernel multiplies on, by input dtype: paged
# fp32 pages on the CUDA cores, flash fp32 on the tensor cores in 3xTF32
# (its bound counts the useful products only, at the TF32 peak)
PEAK_FLOP_PER_S = {torch.float32: FP32_FLOP_PER_S, torch.bfloat16: BF16_FLOP_PER_S}
FLASH_PEAK_FLOP_PER_S = {torch.float32: TF32_FLOP_PER_S, torch.bfloat16: BF16_FLOP_PER_S}
# kernel vs plain: fp32 sums in another order (tests/test_kernels.py's bars)
TOL = {"binary_ip": dict(rtol=1e-5, atol=1e-4), "int4_dist": dict(rtol=1e-4, atol=1e-3)}
# attention kernel vs plain on the same inputs, by input dtype.  Both compute
# in fp32 (sums in another order: under 1e-6 apart) and round the output to
# the input dtype once, so in bf16 they differ by at most one bf16 ulp (2^-7
# of the value) where their fp32 results straddle a rounding point
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}
# the SDPA yardstick vs plain, a check that it computes the same function
# (its masks), not of its accuracy: in bf16 its kernels round each
# probability to bf16 before the product with V, an error of 2^-9 of each
# p * v term that does not shrink with the output where terms cancel
# (readings on an H100 up to 1.6e-2, at outputs below 0.7)
LIB_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=3e-2)}
# Yi-6B attention (src/repro/configs/yi_6b.py): 32 query heads, 4 KV heads,
# head dim 128; KV pages of 16 tokens
YI = dict(H=32, KVH=4, Dh=128, page=16)
# the reduced Yi-6B config's attention (yi_6b.py REDUCED: 4/2 heads, Dh 16,
# the head width of every reduced config) and granite-20b's (granite_20b.py:
# 48 query heads over one KV head of Dh 128, a group wider than one block)
YI_REDUCED = dict(H=4, KVH=2, Dh=16, page=16)
GRANITE = dict(H=48, KVH=1, Dh=128, page=16)
# each row's time before its kernel's Hopper redesign (ms, CUDA events,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), where PERF.md recorded
# one, by (kernel, shape, input dtype): the bf16 attention rows and paged
# fp32 before the tensor-core redesign of those kernels, fp32 flash and
# int4_dist before theirs, binary_ip's sign product before its own
EARLIER_MS = {
    ("paged_attention", "B=8 ctx=2048", "bfloat16"): 0.391,
    ("paged_attention", "B=32 ctx=4096", "bfloat16"): 0.783,
    ("paged_attention", "B=8 ctx=2048", "float32"): 0.473,
    ("flash_attention", "yi-6b prefill S=2048", "bfloat16"): 1.624,
    ("flash_attention", "gemma3-1b local S=2048 w=512", "bfloat16"): 0.217,
    ("flash_attention", "whisper-small encoder S=1500", "bfloat16"): 0.444,
    ("flash_attention", "yi-6b prefill S=512", "float32"): 0.1715,
    ("int4_dist", "B=8 N=256 d=128 table=1000000 gathered", "float32"): 0.0581,
    ("int4_dist", "B=8 N=1000000 d=128 table=1000000 sweep", "float32"): 0.1110,
    ("binary_ip", "B=8 N=256 d=128 table=1000000 gathered", "float32"): 0.0371,
    ("binary_ip", "B=8 N=1000000 d=128 table=1000000 sweep", "float32"): 0.0856,
}
# engine vs the NumPy batch engine, whose estimator epilogue is float64
HOST_TOL = dict(rtol=2e-3, atol=2e-3)
# every kernel: its source, the TPU kernel it replaces, its launch counter,
# the phases whose runs give its reported launches (summed), and the fields
# of the row whose times the report carries (binary_ip's: the fused
# estimate, which is what the search path launches)
SIFT1M_FLUSH = dict(shape="B=8 N=256 d=128 table=1000000 gathered", dtype="float32")
SCAN_SELECT_MAIN = "B=4096 L=32768 C=64 mid-scan"
LM_FLASH_SHAPE = "yi-6b lm serve prefill B=4 S=2048"
TRAIN_FLASH_SHAPE = "tinyllama-1.1b lm train B=4 S=2048"
TINYLLAMA = dict(H=32, KVH=4, Dh=64)  # src/repro/configs/tinyllama_1_1b.py
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 10
ADAMW8_STEPS = 3  # the full-width adamw8 run's steps
KERNELS = {
    "binary_ip": dict(source="src/repro_torch/csrc/binary_ip.cu",
                      replaces="src/repro/kernels/binary_ip/kernel.py:28",
                      counter=bip_kernel,
                      paths=("search", "serving plane", "velo device", "verify", "examples"),
                      main=dict(SIFT1M_FLUSH, entry="estimate_dist2")),
    "int4_dist": dict(source="src/repro_torch/csrc/int4_dist.cu",
                      replaces="src/repro/kernels/int4_dist/kernel.py:27",
                      counter=i4_kernel,
                      paths=("search", "serving plane", "verify", "examples"),
                      main=SIFT1M_FLUSH),
    # scan_search's stage-1 chunk epilogue at the benchmark's shape, mid-scan
    "scan_select": dict(source="src/repro_torch/csrc/scan_select.cu",
                        replaces="none (src/repro/velo/scan_search.py:91-103, XLA ops and "
                                 "lax.top_k)",
                        counter=sel_kernel, paths=("velo device", "examples"),
                        main=dict(shape=SCAN_SELECT_MAIN, dtype="float32")),
    # a decode step of 8 sequences x 2048 tokens, bf16 pages
    "paged_attention": dict(source="src/repro_torch/csrc/paged_attention.cu",
                            replaces="src/repro/kernels/paged_attention/kernel.py:29",
                            counter=pa_kernel, paths=("kv serve",),
                            main=dict(shape="B=8 ctx=2048", dtype="bfloat16")),
    # the LM serving path's prefill attention: Yi-6B, 4 requests x 2 048
    # tokens, bf16 (its launches: phase 3's, the lm serve phase's and the lm
    # train phase's, whose steps launch it in every attention layer's
    # forward and again in its remat recompute)
    "flash_attention": dict(source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention/kernel.py:33",
                            counter=fa_kernel,
                            paths=("attention kernels", "lm serve", "lm train", "lm shard"),
                            main=dict(shape=LM_FLASH_SHAPE, dtype="bfloat16")),
}
# kv serve: the pool cut so that 16 live requests of ~1 280 tokens (~1 300
# pages) oversubscribe it, and one layer's share of an 80 GB card for Yi-6B
# in bf16 ((80 GB - 12 GB of weights) / 32 layers / 32 KiB a page, less
# headroom), where the same traffic never evicts
KV_CUT_PAGES, KV_LAYER_PAGES = 1024, 60_000
KV_REQUESTS = 48
KV_CHECK_EVERY = 16  # decode steps between checks against the plain version
# the seeded traffic's bookkeeping on each pool (pinned on the CPU by
# tests/test_torch_kv_serving.py): steps, evictions (= swap-ins), table
# repasses; and the attention ms per step (mean, CUDA events, H100 80GB
# HBM3, 700 W) before the kernel's redesign, from PERF.md
KV_EXPECT = {KV_CUT_PAGES: (321, 34_417, 25), KV_LAYER_PAGES: (319, 0, 0)}
KV_EARLIER_MS = {KV_CUT_PAGES: 0.480, KV_LAYER_PAGES: 0.441}


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["counter"].launches = 0


def read_launches() -> dict[str, int]:
    return {name: spec["counter"].launches for name, spec in KERNELS.items()}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


SASS_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_tf32_kernel",
                "paged_attention_mma_kernel", "paged_attention_f32_kernel", "binary_mma_kernel")


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    """Tensor-core instructions (Hopper's HGMMA, mma.sync's HMMA, and of
    those the ones on TF32 operands) in each attention kernel family and in
    binary_ip's tensor-core path, from cuobjdump -sass beside nvcc; empty
    when cuobjdump is missing."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = next((k for k in SASS_KERNELS if k in fn), None)
            if name is not None:
                counts.setdefault(name, {"HGMMA": 0, "HMMA": 0, "TF32": 0})
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                counts[name][op] += f" {op}." in line
            counts[name]["TF32"] += ("MMA." in line) and ".TF32" in line
    return counts


def time_ms(fn, reps: int = 30, warmup: int = 5, flush: torch.Tensor | None = None) -> float:
    """Median device time of one call, CUDA events around each call; with
    ``flush``, the buffer is overwritten before each call (outside the
    events) so that the call finds its inputs out of the L2 cache."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in ev:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def host_ms(fn, reps: int = 20) -> float:
    """Median wall time of one call that ends on the host (results downloaded)."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def device_us(fn, reps: int = 30, flush: torch.Tensor | None = None,
              key: str | None = None) -> float | None:
    """Device time of one call in microseconds: the summed self time of the
    kernels the CUDA profiler (CUPTI) records over ``reps`` calls, per call
    (only kernels whose name holds ``key``, when given; ``flush`` as in
    ``time_ms``).  None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if key is None or key in e.key)
    return total / reps if total > 0 else None


def bound_ms(nbytes: int, flops: int, flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _profile(fn):
    """One call of ``fn`` under the CUDA profiler: (its wall seconds, the
    kernels, the copies and fills), each a list of key averages with device
    time, longest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    copy = ("Memcpy", "Memset")
    return (wall, [e for e in avgs if not e.key.startswith(copy)],
            [e for e in avgs if e.key.startswith(copy)])


def profiled_kernels(fn, attempts: int = 3) -> dict[str, int]:
    """The CUDA kernels (copies and fills left out) that the profiler records
    in one call of ``fn``: name -> count.  The profiler sometimes loses a
    record, so an empty reading is taken again, up to ``attempts`` times."""
    fn()
    torch.cuda.synchronize()
    kernels: dict[str, int] = {}
    for _ in range(attempts):
        kernels = {e.key: e.count for e in _profile(fn)[1]}
        if kernels:
            break
    return kernels


# ------------------------------------------------------------------ phase 3


def _shape(B: int, N: int, d: int, T: int, gather: bool) -> str:
    return f"B={B} N={N} d={d} table={T} {'gathered' if gather else 'sweep'}"


def check_binary_ip(dev, gen, B, N, d, T, gather, q_dtype=torch.float32,
                    entry="binary_ip") -> dict:
    """One binary_ip row: the sign product (``entry`` "binary_ip") or the
    fused RaBitQ estimate ("estimate_dist2") over N rows of a T-row table,
    gathered by id or swept.  The bound counts the bytes once and the useful
    operations at the peak of the units the call's path multiplies on (the
    tensor cores' bf16 peak for a sweep, the CUDA cores' fp32 peak for the
    lanes path; a sweep also gets the fp32-peak bound, for continuity).  No
    single PyTorch call computes the estimate: its row's library_ms is None,
    and matmul_ms times torch.matmul on the same rows unpacked, the sign
    product alone, as a labelled yardstick."""
    q = torch.randn(B, d, generator=gen, device=dev).to(q_dtype)
    codes = torch.randint(0, 256, (T, d // 8), generator=gen, device=dev, dtype=torch.uint8)
    ids = torch.randint(0, T, (N,), generator=gen, device=dev) if gather else None
    est = entry == "estimate_dist2"
    norms = torch.rand(T, generator=gen, device=dev) * 2 + 0.25
    ipb = torch.rand(T, generator=gen, device=dev) * 0.9 + 0.05

    def kernel():
        if est:
            return bip_ops.estimate_dist2(q, codes, norms, ipb, ids)
        return bip_ops.binary_ip(q, codes, ids)

    def plain():
        rows = (codes, norms, ipb) if ids is None else (codes[ids], norms[ids], ipb[ids])
        if est:
            return bip_ref.estimate_dist2_ref(q, *rows)
        return bip_ref.binary_ip_ref(q, rows[0])

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    shape = _shape(B, N, d, T, gather)
    require(torch.allclose(got, want, **TOL["binary_ip"]),
            f"binary_ip {entry} disagrees with its plain version at {shape} {q_dtype}: {err}")
    signs = bip_ref.unpack_signs(codes if ids is None else codes[ids], d)
    qf = q.float()
    tc = bip_kernel.tensor_core_path(B, N, d, codes.data_ptr())
    nbytes = q.numel() * q.element_size() + N * d // 8 + (N * 8 if gather else 0) + B * N * 4
    flops = 2 * B * N * d
    if est:  # norms and ip_bar of each row; ||q||, the scale and the epilogue
        nbytes += 2 * N * 4
        flops += 2 * B * d + 11 * B * N
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S if tc else FP32_FLOP_PER_S)
    matmul_ms = time_ms(lambda: torch.matmul(qf, signs.T))
    return dict(
        kernel="binary_ip", entry=entry, path="tensor cores" if tc else "lanes", shape=shape,
        B=B, N=N, d=d, table=T, dtype=str(q_dtype)[6:], max_abs_err=err,
        ms=time_ms(kernel), plain_ms=time_ms(plain),
        library_ms=None if est else matmul_ms, matmul_ms=matmul_ms,
        device_us=device_us(kernel), plain_device_us=device_us(plain),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops,
        bound_fp32_ms=bound_ms(nbytes, flops)[0] if tc else None,
        earlier_ms=None if est else EARLIER_MS.get(("binary_ip", shape, str(q_dtype)[6:])),
    )


def check_int4_dist(dev, gen, B, N, d, T, gather) -> dict:
    q = torch.randn(B, d, generator=gen, device=dev)
    codes = torch.randint(0, 256, (T, d // 2), generator=gen, device=dev, dtype=torch.uint8)
    lo = torch.rand(T, generator=gen, device=dev) - 2.0
    step = torch.rand(T, generator=gen, device=dev) * 0.2 + 0.1
    ids = torch.randint(0, T, (N,), generator=gen, device=dev) if gather else None
    got = i4_ops.int4_dist2(q, codes, lo, step, ids)
    rows = (codes, lo, step) if ids is None else (codes[ids], lo[ids], step[ids])
    want = i4_ref.int4_dist2_ref(q, *rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, **TOL["int4_dist"]),
            f"int4_dist disagrees with its plain version at B={B} N={N} d={d}: {err}")
    x = i4_ref.unpack_nibbles(rows[0], d) * rows[2][:, None] + rows[1][:, None]

    def plain():
        r = (codes, lo, step) if ids is None else (codes[ids], lo[ids], step[ids])
        return i4_ref.int4_dist2_ref(q, *r)

    nbytes = B * d * 4 + N * (d // 2 + 8) + (N * 8 if gather else 0) + B * N * 4
    b_ms, b_by = bound_ms(nbytes, 2 * B * N * d + 4 * N * d)
    return dict(
        kernel="int4_dist", entry="int4_dist2", path="lanes", shape=_shape(B, N, d, T, gather),
        B=B, N=N, d=d, table=T, dtype="float32", max_abs_err=err,
        ms=time_ms(lambda: i4_ops.int4_dist2(q, codes, lo, step, ids)),
        plain_ms=time_ms(plain),
        library_ms=time_ms(lambda: torch.matmul(q, x.T)),
        device_us=device_us(lambda: i4_ops.int4_dist2(q, codes, lo, step, ids)),
        plain_device_us=device_us(plain),
        bound_ms=b_ms, bound_by=b_by,
        earlier_ms=EARLIER_MS.get(("int4_dist", _shape(B, N, d, T, gather), "float32")),
    )


def check_scan_select(dev, gen, B: int, L: int, C: int, mid: bool) -> dict:
    """One scan_select row: a chunk of L rows for B bf16 unit queries at d =
    128 (codes, norms and ip_bar from the seed), from the first carry (the
    full select of every row) or from the carry of a chunk before it (the
    filter), held bit for bit against the plain chain on the same product.
    The bound counts the bytes once: the (B, L) fp32 product, the chunk's
    10 bytes a row of tables, the queries' 4 bytes and the carry in and
    out."""
    d = 128
    codes = torch.randint(0, 256, (2 * L, d // 8), generator=gen, device=dev, dtype=torch.uint8)
    norms = torch.rand(2 * L, generator=gen, device=dev) * 2 + 0.25
    ipb = torch.rand(2 * L, generator=gen, device=dev) * 0.9 + 0.05
    q = torch.randn(B, d, generator=gen, device=dev)
    q = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).to(torch.bfloat16)
    qnorm = torch.rand(B, 1, generator=gen, device=dev) * 1.5 + 0.5
    carry = (torch.full((B, C), 3e38, dtype=torch.bfloat16, device=dev),
             torch.zeros((B, C), dtype=torch.int64, device=dev))
    lo = L if mid else 0
    if mid:
        carry = sel_ref.scan_select_ref(bip_ops.binary_ip(q, codes[:L]), qnorm, norms[:L],
                                        ipb[:L], d, C, 0, carry)
    g = bip_ops.binary_ip(q, codes[lo:lo + L])
    qtab, rtab, ipt = sel_kernel.tables(qnorm, norms, ipb)
    rows = slice(lo, lo + L)

    def kernel():
        return sel_kernel.scan_select_cuda(g, qtab, rtab[rows], ipt[rows], d, C, lo, carry)

    def plain():
        return sel_ref.scan_select_ref(g, qnorm, norms[rows], ipb[rows], d, C, lo, carry)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    shape = f"B={B} L={L} C={C} {'mid-scan' if mid else 'first chunk'}"
    same = torch.equal(got[1], want[1]) and torch.equal(got[0].view(torch.int16),
                                                        want[0].view(torch.int16))
    require(same, f"scan_select disagrees with its plain version at {shape}")
    nbytes = B * L * 4 + L * 10 + B * 4 + 2 * B * C * 10
    b_ms, b_by = bound_ms(nbytes, 11 * B * L)
    return dict(
        kernel="scan_select", entry="scan_select", path="filter" if mid else "full select",
        shape=shape, B=B, N=L, d=d, table=2 * L, dtype="float32",
        max_abs_err=float((got[0].float() - want[0].float()).abs().nan_to_num().max()),
        ms=time_ms(kernel), plain_ms=time_ms(plain), library_ms=None,
        device_us=device_us(kernel), plain_device_us=device_us(plain),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, earlier_ms=None,
    )


def _us(x: float | None) -> str:
    return "n/m" if x is None else f"{x:.2f}"


def phase_kernels(dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for d in (128, 960):
        for B in (1, 8):
            for N in (64, 256):
                rows.append(check_binary_ip(dev, gen, B, N, d, 10_000, gather=True))
                rows.append(check_int4_dist(dev, gen, B, N, d, 10_000, gather=True))
    rows.append(check_binary_ip(dev, gen, 8, 256, 960, 10_000, True, torch.bfloat16))
    for B in (1, 8):  # SIFT1M scale: a 1M x 128 resident table, 256 gathered rows
        rows.append(check_binary_ip(dev, gen, B, 256, 128, 1_000_000, gather=True))
        rows.append(check_int4_dist(dev, gen, B, 256, 128, 1_000_000, gather=True))
    # the fused estimate at the search path's flush (ids into 1M rows)
    for d in (128, 960):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_binary_ip(dev, gen, 8, 256, d, 1_000_000, True, dtype,
                                        "estimate_dist2"))
    # sweeps of the 1M table (the tensor-core path)
    rows.append(check_binary_ip(dev, gen, 8, 1_000_000, 128, 1_000_000, gather=False))
    rows.append(check_binary_ip(dev, gen, 8, 1_000_000, 128, 1_000_000, False, torch.bfloat16))
    rows.append(check_binary_ip(dev, gen, 8, 1_000_000, 128, 1_000_000, False, torch.float32,
                                "estimate_dist2"))
    rows.append(check_int4_dist(dev, gen, 8, 1_000_000, 128, 1_000_000, gather=False))
    # scan_search's stage-1 launches over the 1M table: a 32 768-row chunk
    # and the 16 960-row tail, bf16 queries at B in {8, 64}
    for B in (8, 64):
        for N in (32_768, 16_960):
            rows.append(check_binary_ip(dev, gen, B, N, 128, N, False, torch.bfloat16))
    print(f"{'kernel':10} {'entry':14} {'path':12} {'B':>2} {'N':>8} {'d':>4} {'table':>8} "
          f"{'q':>8} {'max_err':>9} {'ms':>9} {'plain_ms':>9} {'lib_ms':>10} {'bound_ms':>9} "
          f"{'dev_us':>8} {'pl_dev_us':>9} {'prev_ms':>8} by")
    for r in rows:
        earlier = "—" if r.get("earlier_ms") is None else f"{r['earlier_ms']:.4f}"
        lib = (f"{r['library_ms']:10.5f}" if r["library_ms"] is not None
               else f"{r['matmul_ms']:9.5f}*")
        print(f"{r['kernel']:10} {r['entry']:14} {r['path']:12} {r['B']:>2} {r['N']:>8} "
              f"{r['d']:>4} {r['table']:>8} {r['dtype']:>8} {r['max_abs_err']:9.2e} "
              f"{r['ms']:9.5f} {r['plain_ms']:9.5f} {lib} {r['bound_ms']:9.6f} "
              f"{_us(r['device_us']):>8} {_us(r['plain_device_us']):>9} {earlier:>8} "
              f"{r['bound_by']}")
    print("  * no PyTorch call computes the estimate: torch.matmul of the sign product "
          "alone, as a yardstick")
    for r in rows:
        if r.get("bound_fp32_ms") is not None:
            print(f"  binary_ip {r['entry']} {r['shape']} {r['dtype']}: bound {r['bound_ms']:.6f} "
                  f"ms ({r['bound_by']}) at the bf16 tensor-core peak, "
                  f"{r['bound_fp32_ms']:.6f} ms at the fp32 (CUDA-core) peak")
    # scan_search's stage-1 epilogue: the benchmark's chunk (first and mid-scan),
    # phase 7's B 8 and 64, and the 1M table's 16 960-row tail
    sel = [check_scan_select(dev, gen, 4096, 32_768, 64, False),
           check_scan_select(dev, gen, 4096, 32_768, 64, True)]
    sel += [check_scan_select(dev, gen, B, 32_768, 64, True) for B in (8, 64)]
    sel.append(check_scan_select(dev, gen, 64, 16_960, 64, True))
    for r in sel:
        print(f"scan_select {r['path']:11} {r['shape']:34} equal  ms {r['ms']:.5f} "
              f"plain_ms {r['plain_ms']:.5f} bound_ms {r['bound_ms']:.6f} ({r['bound_by']}) "
              f"dev_us {_us(r['device_us'])} pl_dev_us {_us(r['plain_device_us'])}")
    return rows + sel


def _check(kernel: str, shape: str, dtype, got, want, lib_out) -> tuple[float, float]:
    """Hold a kernel's output and the yardstick's against the plain
    version's; their max abs errors."""
    torch.cuda.synchronize()
    got, want, lib_out = got.float(), want.float(), lib_out.float()
    err = float((got - want).abs().max())
    lib_err = float((lib_out - want).abs().max())
    tag = f"{shape} {str(dtype)[6:]}"
    require(torch.allclose(got, want, **ATTN_TOL[dtype]),
            f"{kernel} disagrees with its plain version at {tag}: {err}")
    require(torch.allclose(lib_out, want, **LIB_TOL[dtype]),
            f"the SDPA yardstick computes another function at {tag}: {lib_err}")
    return err, lib_err


def check_paged(dev, gen, B, ctx, dtype, flush, widths=YI, model="") -> dict:
    """paged_attention at ``widths`` (Yi-6B's unless given; ``model`` then
    prefixes the row's shape): B sequences of ``ctx`` tokens (the last one
    ragged: 7 tokens, below a page; at B = 1, ctx - 5), block tables a
    seeded permutation of the B * ctx / 16 pages.  Times are taken with the
    L2 cache flushed before each call, as a decode step finds one layer's
    pages."""
    H, KVH, Dh, page = widths["H"], widths["KVH"], widths["Dh"], widths["page"]
    max_pages = ctx // page
    P = B * max_pages
    q = torch.randn(B, H, Dh, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, page, KVH, Dh, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, page, KVH, Dh, generator=gen, device=dev).to(dtype)
    bt = torch.randperm(P, generator=gen, device=dev).to(torch.int32).reshape(B, max_pages)
    cl = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    cl[-1] = 7 if B > 1 else ctx - 5

    def kernel():
        return pa_ops.paged_attention(q, kp, vp, bt, cl)

    def plain():
        return pa_ref.paged_attention_ref(q, kp, vp, bt, cl)

    # the yardstick: one SDPA call on K/V gathered dense beforehand, with a
    # boolean mask of the context lengths, on the memory-efficient backend;
    # the query group of each KV head is its G rows, so no GQA is asked for
    S = max_pages * page
    G = H // KVH
    kd = kp[bt.long()].reshape(B, S, KVH, Dh).transpose(1, 2).contiguous()
    vd = vp[bt.long()].reshape(B, S, KVH, Dh).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, :] < cl[:, None])[:, None, None, :]
    qg = q.reshape(B, KVH, G, Dh)

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return sdpa(qg, kd, vd, attn_mask=mask)

    shape = f"{model} B={B} ctx={ctx}".strip()
    err, lib_err = _check("paged_attention", shape, dtype, kernel(), plain(),
                          library().reshape(B, H, Dh))
    tokens = int(cl.sum())
    es = q.element_size()
    pages_read = int(((cl + page - 1) // page).sum())
    nbytes = 2 * q.numel() * es + 2 * tokens * KVH * Dh * es + pages_read * 4 + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * H * Dh * tokens, PEAK_FLOP_PER_S[dtype])
    return _rates(dict(
        kernel="paged_attention", shape=shape, B=B, H=H, KVH=KVH, Dh=Dh, ctx=ctx,
        dtype=str(dtype)[6:], max_abs_err=err, library_err=lib_err,
        ms=time_ms(kernel, flush=flush), plain_ms=time_ms(plain, flush=flush),
        library_ms=time_ms(library, flush=flush), library_backend="efficient",
        device_us=device_us(kernel, flush=flush, key="paged_"),  # split + combine
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes,
    ))


def check_flash(dev, gen, name, B, H, KVH, S, Dh, causal, window, dtype) -> dict:
    """flash_attention on one prefill: q, k, v of S tokens."""
    q = torch.randn(B, H, S, Dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, KVH, S, Dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, KVH, S, Dh, generator=gen, device=dev).to(dtype)

    def kernel():
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)

    def plain():
        return fa_ref.attention_ref(q, k, v, causal=causal, window=window)

    # the yardstick: SDPA on a pinned backend.  The flash backend (bf16, no
    # explicit mask; its is_causal aligns top-left, and Sq == Skv here) takes
    # GQA itself; elsewhere the memory-efficient backend with an explicit
    # boolean mask, each KV head's query group folded into G * S rows so that
    # no GQA is asked for
    pos = torch.arange(S, device=dev)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    G = H // KVH
    flash = dtype == torch.bfloat16 and window is None
    qg, gmask = q.reshape(B, KVH, G * S, Dh), mask.repeat(G, 1)

    def library():
        if flash:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return sdpa(qg, k, v, attn_mask=gmask).reshape(B, H, S, Dh)

    err, lib_err = _check("flash_attention", name, dtype, kernel(), plain(), library())
    pairs = int(mask.sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * B * H * Dh * pairs
    b_ms, b_by = bound_ms(nbytes, flops, FLASH_PEAK_FLOP_PER_S[dtype])
    # fp32: also the bound at the CUDA cores' fp32 peak, beside the TF32
    # one, so that the rows stay comparable with those recorded before
    fp32_ms = bound_ms(nbytes, flops)[0] if dtype == torch.float32 else None
    return _rates(dict(
        kernel="flash_attention", shape=name, B=B, H=H, KVH=KVH, S=S, Dh=Dh, causal=causal,
        window=window, dtype=str(dtype)[6:], max_abs_err=err, library_err=lib_err,
        ms=time_ms(kernel), plain_ms=time_ms(plain), library_ms=time_ms(library),
        library_backend="flash" if flash else "efficient",
        device_us=device_us(kernel, key="flash_attention"),
        bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms, flops=flops, nbytes=nbytes,
    ))


def _rates(r: dict) -> dict:
    """Add the achieved rate of the work the bound counts (TFLOP/s when
    operations bound it, GB/s when bytes do), the bound's share of the
    measured time (CUDA events; and of the profiler's device time), and the
    row's time before the kernels' redesign where PERF.md recorded one."""
    work = r["flops"] / 1e12 if r["bound_by"] == "operations" else r["nbytes"] / 1e9
    r["rate"] = work / (r["ms"] / 1e3)
    r["rate_unit"] = "TFLOP/s" if r["bound_by"] == "operations" else "GB/s"
    r["bound_share"] = r["bound_ms"] / r["ms"]
    dev = r["device_us"]
    r["device_bound_share"] = None if dev is None else r["bound_ms"] / (dev / 1e3)
    r["earlier_ms"] = EARLIER_MS.get((r["kernel"], r["shape"], r["dtype"]))
    return r


def phase_attention(dev, card: str) -> tuple[list[dict], dict[str, int]]:
    """Phase 3's attention rows and the launches they made (flash_attention's
    only ones: no system path of the package calls that kernel)."""
    reset_launches()
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > the 50 MB L2
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8, 32):
            for ctx in (512, 2048, 4096):
                rows.append(check_paged(dev, gen, B, ctx, dtype, flush))
    del flush
    yi = dict(B=1, H=YI["H"], KVH=YI["KVH"], Dh=YI["Dh"], causal=True, window=None)
    for S in (512, 2048):
        rows.append(check_flash(dev, gen, f"yi-6b prefill S={S}", S=S, dtype=torch.bfloat16, **yi))
    # the lm serve phase's call: 4 requests of 2 048 tokens
    rows.append(check_flash(dev, gen, LM_FLASH_SHAPE, **dict(yi, B=4), S=2048,
                            dtype=torch.bfloat16))
    # the lm train phase's call: TinyLlama-1.1B, 4 sequences of 2 048 tokens
    rows.append(check_flash(dev, gen, TRAIN_FLASH_SHAPE, TRAIN_B, TINYLLAMA["H"],
                            TINYLLAMA["KVH"], TRAIN_S, TINYLLAMA["Dh"], True, None,
                            torch.bfloat16))
    rows.append(check_flash(dev, gen, "gemma3-1b local S=2048 w=512", 1, 4, 1, 2048, 256,
                            True, 512, torch.bfloat16))
    rows.append(check_flash(dev, gen, "whisper-small encoder S=1500", 1, 12, 12, 1500, 64,
                            False, None, torch.bfloat16))
    rows.append(check_flash(dev, gen, "yi-6b prefill S=512", S=512, dtype=torch.float32, **yi))
    rows.append(check_flash(dev, gen, "gemma3-1b local S=2048 w=512", 1, 4, 1, 2048, 256,
                            True, 512, torch.float32))
    rows.append(check_flash(dev, gen, "whisper-small encoder S=1500", 1, 12, 12, 1500, 64,
                            False, None, torch.float32))
    # the repaired shapes: Dh 16 (the reduced Yi-6B config: 4/2 heads),
    # prefill and decode in both dtypes, and granite-20b's full decode
    # (group 48 x Dh 128, split over two blocks of 24 heads)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    red = YI_REDUCED
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_flash(dev, gen, "yi-6b-reduced prefill B=8 S=2048", 8, red["H"],
                                red["KVH"], 2048, red["Dh"], True, None, dtype))
        rows.append(check_paged(dev, gen, 8, 2048, dtype, flush, red, "yi-6b-reduced"))
    rows.append(check_flash(dev, gen, "yi-6b-reduced prefill B=8 S=2048 w=512", 8, red["H"],
                            red["KVH"], 2048, red["Dh"], True, 512, torch.bfloat16))
    rows.append(check_paged(dev, gen, 8, 2048, torch.bfloat16, flush, GRANITE, "granite-20b"))
    del flush
    launches = read_launches()
    print(f"attention kernels on {card}:")
    print(f"{'kernel':15} {'shape':40} {'dtype':8} {'max_err':>9} {'lib_err':>9} {'ms':>9} "
          f"{'prev_ms':>8} {'plain_ms':>9} {'lib_ms':>9} {'sdpa':9} {'bound_ms':>9} "
          f"{'dev_us':>9} {'rate':>8} {'unit':7} {'share':>6} {'dev_sh':>6} by")
    for r in rows:
        earlier = "—" if r["earlier_ms"] is None else f"{r['earlier_ms']:.3f}"
        dsh = "n/m" if r["device_bound_share"] is None else f"{r['device_bound_share']:.3f}"
        print(f"{r['kernel']:15} {r['shape']:40} {r['dtype']:8} {r['max_abs_err']:9.2e} "
              f"{r['library_err']:9.2e} {r['ms']:9.5f} {earlier:>8} {r['plain_ms']:9.5f} "
              f"{r['library_ms']:9.5f} {r['library_backend']:9} {r['bound_ms']:9.6f} "
              f"{_us(r['device_us']):>9} {r['rate']:8.1f} {r['rate_unit']:7} "
              f"{r['bound_share']:6.3f} {dsh:>6} {r['bound_by']}")
    for r in rows:
        if r.get("bound_fp32_ms") is not None:
            print(f"  {r['shape']} fp32: bound {r['bound_ms']:.6f} ms at the TF32 peak, "
                  f"{r['bound_fp32_ms']:.6f} ms at the fp32 (CUDA-core) peak")
    return rows, launches


# ------------------------------------------------------------------ phase 4


def phase_tables(rng, n: int = 1_000_000, d: int = 128) -> tuple[dict, object, np.ndarray]:
    """The report, the 1M-row QuantizedBase and its base vectors (which the
    velo device phase scans)."""
    base = rng.standard_normal((n, d), dtype=np.float32)
    t0 = time.perf_counter()
    qb = RabitQuantizer(d, seed=0).fit_encode(base)
    fit_s = time.perf_counter() - t0
    pqs = [RabitQuantizer.prepare_query(qb, q)
           for q in rng.standard_normal((8, d), dtype=np.float32)]
    eng = distance.get_engine("torch")
    host = distance.get_engine("batch")
    torch.cuda.reset_peak_memory_stats()
    eng.register_index(qb)
    require(eng.stats.uploads == 1, "registering the 1M table must be one upload")
    groups = [(pq, rng.integers(0, n, 32)) for pq in pqs]  # one flush: B=8, 256 rows
    for fn in ("estimate_many", "refine_ids_many"):
        for g, w in zip(getattr(eng, fn)(qb, groups), getattr(host, fn)(qb, groups)):
            require(np.allclose(g, w, **HOST_TOL), f"{fn} disagrees with the batch engine")
    est_ms = host_ms(lambda: eng.estimate_many(qb, groups))
    ref_ms = host_ms(lambda: eng.refine_ids_many(qb, groups))
    est_kernels = profiled_kernels(lambda: eng.estimate_many(qb, groups))
    require(sum(est_kernels.values()) == 1 and "binary_lanes_kernel" in next(iter(est_kernels)),
            f"estimate_many must run exactly one CUDA kernel, the fused estimate: {est_kernels}")

    # a chain of fused beam steps over ids drawn from the whole table
    L = 64
    st = [eng.beam_new(L, n) for _ in pqs]
    hst = [host.beam_new(L, n) for _ in pqs]
    prev = [np.empty(0, np.int64)] * len(pqs)
    same, total, step_ms = 0, 0, []
    for k in range(10):
        kw = [dict(fresh=rng.integers(0, n, 32), explored=prev[i][:1]) for i in range(len(pqs))]

        def reqs(states):
            return [beam_mod.BeamRequest(
                kind="estimate", state=s, fresh=kw[i]["fresh"], explored=kw[i]["explored"],
                insert_ids=np.empty(0, np.int64), insert_ds=np.empty(0, np.float32),
                rows=32, flop_s=0.0, pq=pqs[i], qb=qb) for i, s in enumerate(states)]

        t0 = time.perf_counter()
        got = eng.beam_step_many(qb, reqs(st))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        want = host.beam_step_many(qb, reqs(hst))
        for i, (g, w) in enumerate(zip(got, want)):
            require(g.window_len == w.window_len, f"beam step {k}: window length")
            require(np.isclose(g.tail, w.tail, **HOST_TOL),
                    f"beam step {k}: tail {g.tail} vs {w.tail}")
            same += int(np.array_equal(g.frontier, w.frontier))
            total += 1
        prev = [g.frontier for g in got]
    for s, h in zip(st, hst):
        require(np.allclose(s.cand_d.cpu().numpy(), h.cand_d, **HOST_TOL),
                "beam heaps disagree with the batch engine")
    peak = torch.cuda.max_memory_allocated()
    out = dict(fit_encode_s=fit_s, estimate_many_ms=est_ms, refine_ids_many_ms=ref_ms,
               estimate_many_kernels=est_kernels,
               beam_step_ms=float(np.median(step_ms[1:])), beam_frontiers_equal=same / total,
               max_memory_allocated=peak, uploads=eng.stats.uploads)
    require(eng.stats.uploads == 1, "the 1M table must stay registered once")
    print("tables:", json.dumps(out))
    return out, qb, base


# ------------------------------------------------------------------ phase 5


def _ids_of(results, k: int) -> np.ndarray:
    """(queries, k) result ids, -1 where a query returned fewer than k."""
    ids = np.full((len(results), k), -1, dtype=np.int64)
    for i, r in enumerate(results):
        ids[i, : min(k, len(r.ids))] = r.ids[:k]
    return ids


def _velo(ds, graph, qb, backend, device_beam):
    cfg = baselines.SystemConfig(
        buffer_ratio=0.2, batch_size=8, distance_backend=backend, fuse=True,
        device_beam=device_beam, params=baselines.SearchParams(L=64, W=4),
    )
    return baselines.build_system("velo", ds.base, graph, qb, cfg)


def _search(ds, graph, qb, backend, device_beam) -> dict:
    system = _velo(ds, graph, qb, backend, device_beam)
    reset_launches()
    t0 = time.perf_counter()
    results, stats = system.run(ds.queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: v for n, v in read_launches().items() if "search" in KERNELS[n]["paths"]}
    ids = _ids_of(results, ds.k)
    return dict(backend=system.ctx.dist.name, device_beam=device_beam, ids=ids,
                recall=dataset.recall_at_k(ids, ds.groundtruth, ds.k),
                simulated_qps=stats.qps, wall_s=wall, launches=launches,
                dist_uploads=system.ctx.dist.stats.uploads)


def phase_search(n: int = 10_000, d: int = 128) -> tuple[dict, tuple]:
    """The report, and the (dataset, graph, quantized base) the serving and
    velo device phases reuse (the host graph build alone takes minutes)."""
    t0 = time.perf_counter()
    ds = dataset.make_dataset(n=n, d=d, n_queries=200, seed=0)
    graph = vamana.build_vamana(ds.base, R=32, L=64, seed=0)
    qb = RabitQuantizer(ds.dim, seed=0).fit_encode(ds.base)
    build_s = time.perf_counter() - t0
    ref = _search(ds, graph, qb, "batch", False)
    runs = [_search(ds, graph, qb, "torch", beam) for beam in (False, True)]
    for r in runs:
        tag = f"torch device_beam={r['device_beam']}"
        require(r["backend"] == "torch", f"{tag}: the torch engine must serve")
        require(r["recall"] >= ref["recall"] - 0.01,
                f"{tag}: recall {r['recall']} below batch {ref['recall']} - 0.01")
        require(all(v > 0 for v in r["launches"].values()),
                f"{tag}: a kernel was not launched on the search path: {r['launches']}")
        require(r["dist_uploads"] == 1, f"{tag}: dist_uploads {r['dist_uploads']} != 1")
        r["equal_top10_share"] = float(np.mean(np.all(r["ids"] == ref["ids"], axis=1)))
    n_q = len(ds.queries)
    for r in [ref] + runs:
        r.pop("ids")
        r["launches_per_query"] = {k: v / n_q for k, v in r["launches"].items()}
        print("search:", json.dumps(r))
    print(f"search: index build {build_s:.1f} s (host NumPy), 200 queries per run")
    return dict(build_s=build_s, batch=ref, torch=runs), (ds, graph, qb)


# ------------------------------------------------------------------ phase 6


def _same_results(want, got, dists: bool = False) -> bool:
    """ids, hops and reads equal query by query (and dists bit for bit)."""
    return len(want) == len(got) and all(
        np.array_equal(a.ids, b.ids) and a.hops == b.hops and a.reads == b.reads
        and (not dists or np.array_equal(a.dists, b.dists)) for a, b in zip(want, got))


def _serve_cfg(**kw) -> baselines.SystemConfig:
    """The serving phase's velo on the torch engine: fuse on, stride
    prefetch off (the one schedule-sensitive piece, as the parity tests)."""
    kw.setdefault("buffer_ratio", 0.2)
    kw.setdefault("batch_size", 8)
    return baselines.SystemConfig(distance_backend="torch", fuse=True,
                                  params=baselines.SearchParams(L=64, W=4, prefetch=False), **kw)


def phase_serving(ds, graph, qb, card: str) -> dict:
    """The serving plane and the serving-scale contracts on the card, on
    phase 5's index: a 1-tenant plane is the isolated system; a 2-tenant
    statically partitioned plane (two tenants sharing the one index image,
    B = 1) is two isolated systems; velo at S = 1 is unsharded and S = 2
    keeps recall within 0.01; scheduler="rr" with a deadline plan is the
    plan-free run.  Every run is the torch engine on the card."""
    k, n_q = ds.k, len(ds.queries)
    wall: dict[str, float] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    def velo(**kw):
        return baselines.build_system("velo", ds.base, graph, qb, _serve_cfg(**kw))

    reset_launches()
    iso = velo()
    iso_res, iso_stats = timed("isolated", lambda: iso.run(ds.queries))
    require(iso.ctx.dist.name == "torch" and iso.ctx.dist.device.type == "cuda",
            "serving: the isolated system must run the torch engine on the card")
    spec = serving.TenantSpec.from_dataset("t0", ds, graph, qb, system="velo")
    plane = serving.ServingPlane([spec], _serve_cfg(), shared_pool=True)
    prun = timed("plane 1 tenant", lambda: plane.run(workload.uniform_mix([n_q], n_q, seed=0)))
    one_tenant = _same_results(iso_res, prun.tenants[0].results, dists=True)
    require(one_tenant, "serving: a 1-tenant plane differs from the isolated system")
    require(plane.dist.stats.uploads == 1, "serving: the combined table must upload once")

    # two tenants on the one index image and query set; n_q / 2 arrivals in
    # all, so no tenant's queries wrap around
    specs = [serving.TenantSpec.from_dataset(name, ds, graph, qb) for name in ("a", "b")]
    plane2 = serving.ServingPlane(specs, _serve_cfg(batch_size=1), shared_pool=False)
    wl2 = workload.uniform_mix([n_q, n_q], n_q // 2, seed=3)
    run2 = timed("plane 2 tenants B=1", lambda: plane2.run(wl2))
    two_tenants = []
    for tid, sp in enumerate(specs):
        tr = run2.tenants[tid]
        ref_res, _ = timed(f"isolated {sp.name} B=1",
                           lambda: velo(batch_size=1).run(sp.queries[: tr.stats.n_queries]))
        two_tenants.append(_same_results(ref_res, tr.results, dists=True))
    require(all(two_tenants), f"serving: a partitioned tenant differs from its isolated "
            f"system: {two_tenants}")

    s1_res, s1_stats = timed("S=1", lambda: velo(n_shards=1).run(ds.queries))
    s1_equal = (_same_results(iso_res, s1_res, dists=True)
                and s1_stats.makespan_s == iso_stats.makespan_s)
    require(s1_equal, "serving: velo at S = 1 differs from the unsharded run")
    s2_res, s2_stats = timed("S=2", lambda: velo(n_shards=2).run(ds.queries))
    recall = {S: dataset.recall_at_k(_ids_of(r, k), ds.groundtruth, k)
              for S, r in ((1, s1_res), (2, s2_res))}
    require(abs(recall[2] - recall[1]) <= 0.01 and s2_stats.shard_merges > 0,
            f"serving: velo recall at S = 2 {recall[2]} is not within 0.01 of S = 1 {recall[1]}")

    rr_res, rr_stats = timed("rr with a plan", lambda: velo(scheduler="rr").run(
        ds.queries, sla=SlaPlan.build(n_q, sla_ms=5.0)))
    rr_equal = (_same_results(iso_res, rr_res, dists=True)
                and rr_stats.makespan_s == iso_stats.makespan_s)
    require(rr_equal, "serving: scheduler=rr with a plan differs from the plan-free run")
    launches = read_launches()
    require(launches["binary_ip"] > 0 and launches["int4_dist"] > 0,
            f"serving: a kernel was not launched: {launches}")
    out = dict(card=card, queries=n_q, one_tenant_equal=one_tenant,
               two_tenants_equal=two_tenants, s1_equal=s1_equal, recall_s1=recall[1],
               recall_s2=recall[2], rr_plan_equal=rr_equal,
               recall_isolated=dataset.recall_at_k(_ids_of(iso_res, k), ds.groundtruth, k),
               cross_tenant_flushes=run2.stats.cross_tenant_flushes, wall_s=wall,
               launches=launches)
    print("serving plane:", json.dumps(out))
    return out


# ------------------------------------------------------------------ phase 7


def _exact_top(dev, base: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Exact top-k ids by an fp32 torch.matmul on the card: a yardstick for
    recall, not the port's path."""
    x = torch.from_numpy(base).to(dev)
    q = torch.from_numpy(queries).to(dev)
    d2 = (q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
    return torch.topk(d2, k, dim=1, largest=False).indices.cpu().numpy()


def _recall(ids: torch.Tensor, exact: np.ndarray) -> float:
    return dataset.recall_at_k(ids.cpu().numpy(), exact, exact.shape[1])


def _event_call(fn):
    """(result, device ms between CUDA events around the call, wall s)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def _kernel_split(fn) -> dict:
    """One profiled call of ``fn``: the CUDA kernels' summed device time,
    split into binary_ip's kernels (binary_lanes_kernel, binary_mma_kernel),
    the sorts (cub radix sorts and their helpers: every kernel whose name
    says sort) and the rest, with the top kernels by time."""
    fn()
    torch.cuda.synchronize()
    _, kernels, copies = _profile(fn)

    def us(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key))

    total = us(lambda key: True)
    binary = us(lambda key: "binary_lanes_kernel" in key or "binary_mma_kernel" in key)
    sort = us(lambda key: "sort" in key.lower())
    return dict(kernel_us=total, binary_ip_us=binary, sort_us=sort,
                other_us=total - binary - sort,
                copy_us=sum(e.self_device_time_total for e in copies),
                launches=sum(e.count for e in kernels),
                top=[[e.key[:60], e.self_device_time_total, e.count] for e in kernels[:8]])


def check_scan_chunks(index, queries: torch.Tensor) -> dict:
    """binary_ip against binary_ip_ref on each stage-1 launch of a scan:
    the scan's own bf16 unit queries and its chunk views of the codes (the
    tail too).  Every chunk must take the tensor-core path."""
    _, _, qunit = batch_search._prepare_queries(index, queries.to(index.device))
    q = qunit.to(torch.bfloat16)
    codes = index.binary_codes[:-1]
    n, step, err = codes.shape[0], scan_search.DEFAULT_CHUNK, 0.0
    for lo in range(0, n, step):
        blk = codes[lo:lo + step]
        got, want = bip_ops.binary_ip(q, blk), bip_ref.binary_ip_ref(q, blk)
        e = float((got - want).abs().max())
        where = f"scan chunk at row {lo}, B={len(q)} N={len(blk)}"
        require(bip_kernel.tensor_core_path(len(q), len(blk), q.shape[1], blk.data_ptr()),
                f"velo device: {where} is not on binary_ip's tensor-core path")
        require(torch.allclose(got, want, **TOL["binary_ip"]),
                f"velo device: binary_ip disagrees with its plain version at {where}: {e}")
        err = max(err, e)
    return dict(B=len(q), chunks=-(-n // step), tail=n % step, max_abs_err=err)


def phase_velo_device(dev, ds, graph, qb, qb1m, base1m, card: str) -> dict:
    """The velo device plane on the card: batch_search (the lockstep beam,
    all 200 queries, L 64, k 10, 96 steps) and scan_search (binary_ip
    tensor-core stage 1 in chunks of 32 768 rows, stable top-k merges, int4
    rerank) on phase 5's 10 000 x 128 index, against the same functions run
    by the port on the CPU; and scan_search over phase 4's 1M x 128 table at
    B in {8, 64}, with the kernel against use_kernel=False (binary_ip_ref)
    on the card.  Recall@10 is against exact top-10 by an fp32 matmul."""
    k = 10
    out = dict(card=card, runs=[])
    idx = velo_index.from_host(qb, graph, device=dev)
    idx_cpu = velo_index.from_host(qb, graph, device="cpu")
    exact = _exact_top(dev, ds.base, ds.queries, k)
    q_all = torch.from_numpy(ds.queries)
    # a scan reads no adjacency: the 1M table needs no graph, only a medoid
    stand_in = types.SimpleNamespace(adjacency=np.full((len(base1m), 1), -1, np.int32),
                                     medoid=0)
    idx1m = velo_index.from_host(qb1m, stand_in, device=dev)
    q1m = np.random.default_rng(7).standard_normal((64, base1m.shape[1]), dtype=np.float32)
    exact1m = _exact_top(dev, base1m, q1m, k)
    reset_launches()

    def record(name, B, got, want, ev_ms, wall_s, launches, exact_ids, vs):
        same = float(np.mean(np.all(got.cpu().numpy() == want.cpu().numpy(), axis=1)))
        r = dict(name=name, B=B, device_ms=ev_ms, wall_s=wall_s, binary_ip_launches=launches,
                 recall=_recall(got, exact_ids), recall_vs=_recall(want, exact_ids), vs=vs,
                 equal_top10_share=same)
        require(abs(r["recall"] - r["recall_vs"]) <= 0.01,
                f"velo device {name} B={B}: recall {r['recall']} against {vs} {r['recall_vs']}")
        out["runs"].append(r)
        return r

    def batch(index):
        return batch_search.batch_search(index, q_all, L=64, k=k, max_steps=96)

    (ids, d2, steps), ev_ms, wall_s = _event_call(lambda: batch(idx))
    require(bool(torch.isfinite(d2).all()) and ids.shape == (len(ds.queries), k),
            "velo device: batch_search output")
    want = batch(idx_cpu)
    r = record("batch_search 10k", len(ds.queries), ids, want[0], ev_ms, wall_s, 0, exact, "cpu")
    r["steps_equal_share"] = float((steps.cpu() == want[2]).float().mean())
    # the beam's fp32 arithmetic is the CPU's up to the order of sums: every
    # query takes the CPU's steps, and at most 1 % of rows may differ in ids
    require(r["steps_equal_share"] == 1.0 and r["equal_top10_share"] >= 0.99,
            f"velo device: batch_search on the card against the CPU: steps equal in "
            f"{r['steps_equal_share']}, top-10 ids in {r['equal_top10_share']} of the rows")

    n_launch = bip_kernel.launches
    for B in (8, 64):
        q = q_all[:B]
        (ids, _), ev_ms, wall_s = _event_call(lambda: scan_search.scan_search(idx, q, k=k))
        launched = bip_kernel.launches - n_launch
        require(launched == 1, f"velo device: a 10k scan is one binary_ip launch, got {launched}")
        n_launch = bip_kernel.launches
        want_ids, _ = scan_search.scan_search(idx_cpu, q, k=k)
        record("scan_search 10k", B, ids, want_ids, ev_ms, wall_s, launched, exact[:B], "cpu")

    chunks = -(-len(base1m) // scan_search.DEFAULT_CHUNK)
    for B in (8, 64):
        q = torch.from_numpy(q1m[:B])
        n_sel = sel_kernel.launches
        sel_kernel.reset_full_select_rows()
        (ids, d2), ev_ms, wall_s = _event_call(lambda: scan_search.scan_search(idx1m, q, k=k))
        launched = bip_kernel.launches - n_launch
        require(launched == chunks and sel_kernel.launches - n_sel == chunks,
                f"velo device: a 1M scan is {chunks} binary_ip and scan_select launches, got "
                f"{launched} and {sel_kernel.launches - n_sel}")
        require(bool(torch.isfinite(d2).all()), "velo device: 1M scan distances")
        full_rows = sel_kernel.full_select_rows()
        n_launch = bip_kernel.launches
        (want_ids, want_d2), plain_ms, _ = _event_call(
            lambda: scan_search.scan_search(idx1m, q, k=k, use_kernel=False))
        r = record("scan_search 1M", B, ids, want_ids, ev_ms, wall_s, launched, exact1m[:B],
                   "use_kernel=False")
        # the card's stage 1 picks the plain chain's candidates: the same answer
        require(torch.equal(ids, want_ids) and torch.equal(d2, want_d2),
                f"velo device: the 1M scan at B={B} differs from use_kernel=False")
        r.update(plain_device_ms=plain_ms, full_select_rows=full_rows,
                 call_ms=host_ms(lambda: scan_search.scan_search(idx1m, q, k=k), reps=10))
        n_launch = bip_kernel.launches
    out["launches"] = read_launches()
    out["chunk_check"] = [check_scan_chunks(idx1m, torch.from_numpy(q1m[:B])) for B in (8, 64)]
    # where the device time goes (profiled repeats, after the counts are read)
    out["profile"] = {
        "batch_search 10k B=200": _kernel_split(lambda: batch(idx)),
        "scan_search 1M B=64": _kernel_split(
            lambda: scan_search.scan_search(idx1m, torch.from_numpy(q1m), k=k)),
        "scan_search 1M B=8": _kernel_split(
            lambda: scan_search.scan_search(idx1m, torch.from_numpy(q1m[:8]), k=k)),
    }
    for r in out["runs"] + out["chunk_check"]:
        print("velo device:", json.dumps(r))
    for name, p in out["profile"].items():
        print(f"velo device: profile {name}:", json.dumps(p))
    return out


# ------------------------------------------------------------------ phase 8


def phase_kv_serve(dev, card: str, n_pages: int, thrash: bool) -> dict:
    """The paged KV serving plane end to end on the card: one layer's pool of
    ``n_pages`` bf16 pages at Yi-6B widths, continuous batching over
    KV_REQUESTS requests, one paged_attention launch per decode step.
    Prompts and decode tokens are K/V made on the card from a seeded
    generator: there is no model.  ``thrash`` says whether the traffic must
    oversubscribe the pool (evictions and swap-ins) or fit it (neither)."""
    H, KVH, Dh, page = YI["H"], YI["KVH"], YI["Dh"], YI["page"]
    dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(2)
    pool = PagedKVPool(n_pages, page, KVH, Dh, dtype=dtype, device=dev)
    sched = CacheAwareScheduler(pool, max_batch=8, max_running=16)
    # the length mix is a guess, not taken from a published trace
    prompt_lens = rng.integers(512, 2049, KV_REQUESTS)
    new_tokens = rng.integers(32, 65, KV_REQUESTS)
    for rid in range(KV_REQUESTS):
        sched.submit(ServeRequest(rid, int(prompt_lens[rid]), int(new_tokens[rid])))
    reset_launches()
    steps = tokens = prefill_tokens = checks = 0
    max_err, attn = 0.0, []
    host_s = dict(prefill=0.0, decode_append=0.0, tables=0.0, launch=0.0)  # host clock
    t0 = time.perf_counter()
    while not sched.idle:
        batch = sched.next_batch()
        t1 = time.perf_counter()
        for req in sched.running.values():  # prefill the prompts of admitted requests
            if pool.requests[req.rid].context_len == 0:
                kv = torch.randn(req.prompt_len, 2, KVH, Dh, generator=gen, device=dev).to(dtype)
                for t in range(req.prompt_len):
                    pool.append_token(req.rid, kv[t, 0], kv[t, 1])
                prefill_tokens += req.prompt_len
        t2 = time.perf_counter()
        kv = torch.randn(len(batch), 2, KVH, Dh, generator=gen, device=dev).to(dtype)
        for i, req in enumerate(batch):
            pool.append_token(req.rid, kv[i, 0], kv[i, 1])
        t3 = time.perf_counter()
        rids = [r.rid for r in batch]
        max_pages = max(len(pool.requests[r].block_table) for r in rids)
        bt = torch.from_numpy(pool.batch_block_tables(rids, max_pages)).to(dev)
        cl = torch.tensor([pool.requests[r].context_len for r in rids], dtype=torch.int32,
                          device=dev)
        q = torch.randn(len(batch), H, Dh, generator=gen, device=dev).to(dtype)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t4 = time.perf_counter()
        start.record()
        out = pa_ops.paged_attention(q, pool.k_pages, pool.v_pages, bt, cl)
        end.record()
        t5 = time.perf_counter()
        attn.append((start, end))
        for name, dt in zip(host_s, (t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            host_s[name] += dt
        if steps % KV_CHECK_EVERY == 0:
            want = pa_ref.paged_attention_ref(q, pool.k_pages, pool.v_pages, bt, cl)
            err = float((out.float() - want.float()).abs().max())
            require(torch.allclose(out.float(), want.float(), **ATTN_TOL[dtype]),
                    f"kv serve step {steps}: paged_attention disagrees with its plain version: {err}")
            max_err, checks = max(max_err, err), checks + 1
        sched.complete_step(batch)
        steps += 1
        tokens += len(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    attn_ms = [s.elapsed_time(e) for s, e in attn]
    out = dict(card=card, pages=n_pages, page_tokens=page, pool_bytes=2 * pool.k_pages.numel() * 2,
               requests=KV_REQUESTS, steps=steps, decode_tokens=tokens,
               prefill_tokens=prefill_tokens, evictions=pool.evictions, swap_ins=pool.swap_ins,
               hit_rate=pool.hit_rate(), attention_ms_per_step_median=float(np.median(attn_ms)),
               attention_ms_per_step_mean=float(np.mean(attn_ms)),
               attention_ms_per_step_mean_before=KV_EARLIER_MS[n_pages], wall_s=wall,
               host_s=host_s, checks=checks, max_abs_err=max_err,
               table_repasses=pool.table_repasses, launches=launches)
    print("kv serve:", json.dumps(out))
    require(sorted(sched.completed) == list(range(KV_REQUESTS)),
            "kv serve: a request never completed")
    require(tokens == int(new_tokens.sum()), f"kv serve: {tokens} decode tokens, "
            f"expected {int(new_tokens.sum())}")
    require(launches["paged_attention"] == steps,
            f"kv serve: {launches['paged_attention']} paged_attention launches for {steps} steps")
    swapped = (pool.evictions > 0 and pool.swap_ins > 0) if thrash else \
        (pool.evictions == pool.swap_ins == 0)
    require(swapped, f"kv serve on {n_pages} pages: {pool.evictions} evictions, "
            f"{pool.swap_ins} swap-ins")
    counts = (steps, pool.evictions, pool.table_repasses)
    require(counts == KV_EXPECT[n_pages] and pool.swap_ins == pool.evictions,
            f"kv serve on {n_pages} pages: steps, evictions, repasses {counts}, "
            f"swap-ins {pool.swap_ins}; the seeded traffic gives {KV_EXPECT[n_pages]}")
    return out


# ------------------------------------------------------------------ phase 9


# the JAX package's explorer at its own fixture on the CPU (``python -m
# repro.analysis --explore``: 600 x 32, 24 queries, seeds 1-5), ties summed
# over the schedules as its report prints them: (worker, event, slack)
REF_TIES = {"velo": (122, 2940, 0), "diskann": (48, 42, 0), "starling": (42, 36, 0),
            "pipeann": (558, 936, 0), "inmemory": (6, 0, 0), "sla-edf": (156, 2866, 1127)}
VERIFY_FULL_QUERIES = 50  # the full-width explorer leg's queries
# its permuted schedules beside seed 0's: one (it ran seeds 1-3 before the
# examples' phase came, which takes the ~20 s of the two others)
VERIFY_FULL_SEEDS = (1,)


def _tie_sums(reports) -> tuple[int, int, int]:
    return tuple(sum(r.ties.get(kind, 0) for r in reports) for kind in ("worker", "event", "slack"))


def phase_verify(ds, graph, qb, card: str) -> dict:
    """The protocol verifier and the serve CLI on the card, on phase 5's
    index: verified velo (HBM tier on, device_beam off and on) and a verified
    2-tenant serving plane equal their unverified runs with no violation; the
    schedule explorer at the JAX package's fixture (all five algorithms and
    the pure-EDF plane) and at full width (velo, HBM tier on, cbs off) is
    schedule-invariant with ties permuted; ``launch.serve`` reaches the
    quickstart's recall.  Every run is the torch engine on the card."""
    n_q = len(ds.queries)
    wall: dict[str, float] = {}
    launches: dict[str, dict[str, int]] = {}

    def step(name, fn):
        reset_launches()
        bip_kernel.tensor_core_launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        launches[name] = dict(read_launches(), binary_ip_tensor_core=bip_kernel.tensor_core_launches)
        print(f"verify: {name}: {wall[name]:.2f} s, launches {json.dumps(launches[name])}")
        return res

    # 1. verified velo against unverified, device_beam off and on
    def velo(device_beam, verify):
        cfg = baselines.SystemConfig(
            buffer_ratio=0.2, batch_size=8, distance_backend="torch", fuse=True,
            device_beam=device_beam, hbm_tier=True, verify_protocol=verify,
            params=baselines.SearchParams(L=64, W=4))
        system = baselines.build_system("velo", ds.base, graph, qb, cfg)
        return system, system.run(ds.queries)[0]

    velo_out = []
    for beam in (False, True):
        plain, want = step(f"velo device_beam={beam}", lambda: velo(beam, False))
        system, got = step(f"velo device_beam={beam} verified", lambda: velo(beam, True))
        ck = system.checker
        require(system.ctx.dist.name == "torch" and system.ctx.dist.device.type == "cuda",
                "verify: velo must run the torch engine on the card")
        equal = _same_results(want, got, dists=True)
        hbm_calls = sum(v for k, v in ck.calls.items() if k.startswith("hbm."))
        velo_out.append(dict(device_beam=beam, equal=equal, violations=len(ck.violations),
                             flushes=ck.flushes, hbm_calls=hbm_calls, calls=dict(ck.calls)))
        require(equal, f"verify: verified velo (device_beam={beam}) differs from the unverified run")
        require(ck.ok() and ck.flushes > 0 and hbm_calls > 0,
                f"verify: velo device_beam={beam}: {len(ck.violations)} violations, "
                f"{ck.flushes} flushes, {hbm_calls} hbm calls")

    # 2. a verified 2-tenant plane on a shared pool with quotas and the tier
    specs = [serving.TenantSpec.from_dataset(
        f"t{i}", ds, graph, qb, system="velo",
        params=baselines.SearchParams(L=64, W=4, prefetch=False)) for i in range(2)]
    wl = workload.zipfian_mix([n_q, n_q], n_q, s=1.5, seed=0)

    def plane(verify):
        cfg = baselines.SystemConfig(buffer_ratio=0.2, batch_size=8, distance_backend="torch",
                                     fuse=True, tenant_quota=0.6, hbm_tier=True,
                                     verify_protocol=verify)
        p = serving.ServingPlane(specs, cfg, shared_pool=True)
        return p, p.run(wl)

    _, pwant = step("plane 2 tenants", lambda: plane(False))
    pl, pgot = step("plane 2 tenants verified", lambda: plane(True))
    plane_equal = all(_same_results(a.results, b.results, dists=True)
                      for a, b in zip(pwant.tenants, pgot.tenants))
    require(plane_equal, "verify: the verified serving plane differs from the unverified one")
    require(pl.checker.ok() and pl.checker.flushes > 0,
            f"verify: plane: {len(pl.checker.violations)} violations, {pl.checker.flushes} flushes")
    plane_out = dict(equal=plane_equal, violations=len(pl.checker.violations),
                     flushes=pl.checker.flushes, calls=dict(pl.checker.calls),
                     ops=len(wl.tenant_ids), hbm=pl.hbm is not None)

    # 3. the explorer at the JAX package's fixture: 5 algorithms + sla-edf
    reports = step("explore fixture", lambda: {**explore.smoke(device="cuda"),
                                               **explore.smoke_sla(device="cuda")})
    legs = {}
    for name, reps in reports.items():
        ties = _tie_sums(reps)
        legs[name] = dict(schedules=len(reps) - 1, invariant=all(r.equal for r in reps),
                          ties=ties, reference_ties=REF_TIES[name])
        require(legs[name]["invariant"], f"verify: explorer leg {name} is not schedule-invariant: "
                f"{[r.first_diff for r in reps if not r.equal][:1]}")
        require(all(t > 0 for t, ref in zip(ties, REF_TIES[name]) if ref > 0),
                f"verify: explorer leg {name}: ties {ties}, the JAX package's {REF_TIES[name]}")

    # 4. the explorer at full width: velo on phase 5's index, unfused (the
    # smoke's own dispatch) and fused (a permuted schedule changes which
    # queries share a flush), every estimate call's (B, N) recorded to see
    # how far the calls are from binary_ip's tensor-core threshold
    full = (types.SimpleNamespace(base=ds.base, queries=ds.queries[:VERIFY_FULL_QUERIES]), graph, qb)
    estimate = distance.estimate_dist2
    full_out = {}
    for fuse in (False, True):
        shapes: list[tuple[int, int]] = []

        def recorded(q, codes, norms, ip_bar, ids=None, _shapes=shapes):
            _shapes.append((q.shape[0], codes.shape[0] if ids is None else ids.shape[0]))
            return estimate(q, codes, norms, ip_bar, ids)

        def run_under(policy, _fuse=fuse):
            return explore.run_system_under(
                policy, "velo", hbm_tier=True, fixture=full, device="cuda", fuse=_fuse,
                params=baselines.SearchParams(L=64, W=4, cbs=False))

        name = f"explore full width fuse={fuse}"
        distance.estimate_dist2 = recorded
        try:
            reps = step(name, lambda: explore.explore(run_under, VERIFY_FULL_SEEDS))
        finally:
            distance.estimate_dist2 = estimate
        leg = dict(queries=VERIFY_FULL_QUERIES, fuse=fuse, seeds=[r.seed for r in reps],
                   invariant=all(r.equal for r in reps), ties=_tie_sums(reps),
                   estimate_calls=len(shapes), max_B=max(b for b, _ in shapes),
                   max_N=max(n for _, n in shapes),
                   tensor_core_threshold=bip_kernel.TENSOR_CORE_MIN_ROWS,
                   tensor_core_calls=launches[name]["binary_ip_tensor_core"])
        full_out[f"fuse={fuse}"] = leg
        require(leg["invariant"], f"verify: full-width velo (fuse={fuse}) is not "
                f"schedule-invariant: {[r.first_diff for r in reps if not r.equal][:1]}")
        require(sum(leg["ties"]) > 0, f"verify: the full-width explorer (fuse={fuse}) "
                f"permuted no tie")

    # 5. the serve CLI on the card
    cli = step("launch.serve", lambda: serve.main(["--n", "2000", "--d", "128",
                                                   "--queries", "100"]))
    cli_l = launches["launch.serve"]
    require(cli["distance_backend"] == "torch" and cli_l["binary_ip"] > 0
            and cli_l["int4_dist"] > 0 and cli["recall@k"] >= 0.6,
            f"verify: launch.serve: backend {cli['distance_backend']}, launches {cli_l}, "
            f"recall {cli['recall@k']}")

    total = {n: sum(v[n] for v in launches.values()) for n in KERNELS}
    out = dict(card=card, queries=n_q, velo=velo_out, plane=plane_out, explore_fixture=legs,
               explore_full=full_out, serve=dict(cli, argv="--n 2000 --d 128 --queries 100"),
               wall_s=wall, launches_by_step=launches, launches=total)
    print("verify:", json.dumps(out, default=float))
    return out


# ------------------------------------------------------------------ phase 10


# the lm serve phase: Yi-6B at its published widths (src/repro/configs/yi_6b.py,
# bf16), 4 requests of 2 048 prompt tokens, 16 greedy decode steps, each
# retrieving top-5 from phase 5's index; the reduced config's card-vs-CPU
# runs: 4 prompts of 64 tokens, 8 decode steps
LM_B, LM_PROMPT, LM_STEPS, LM_TOPK = 4, 2048, 16, 5
LM_REDUCED_PROMPT, LM_REDUCED_STEPS = 64, 8
# the reduced config on the card against the port on the CPU, same weights:
# logits by dtype (fp32 sums in another order; bf16 rounding of the layers'
# outputs carried through the stack)
LM_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


class FlashRecorder:
    """While active, every flash_attention call of the model (through
    ``fa_ops.flash_attention``, which ``models.layers`` calls) is held
    against ``attention_ref`` on its own q, k, v at phase 3's bar; the
    errors are kept in call order."""

    def __init__(self, phase: str = "lm serve"):
        self.phase = phase
        self.errors: list[float] = []
        self.shapes: list[tuple] = []
        self._real = fa_ops.flash_attention

    def _call(self, q, k, v, causal=True, window=None, scale=None):
        out = self._real(q, k, v, causal=causal, window=window, scale=scale)
        want = fa_ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
        require(torch.allclose(out.float(), want.float(), **ATTN_TOL[q.dtype]),
                f"{self.phase}: flash_attention call {len(self.errors)} disagrees with "
                f"attention_ref")
        self.errors.append(float((out.float() - want.float()).abs().max()))
        self.shapes.append((tuple(q.shape), tuple(k.shape), causal, window, str(q.dtype)[6:]))
        return out

    def __enter__(self):
        fa_ops.flash_attention = self._call
        return self

    def __exit__(self, *exc):
        fa_ops.flash_attention = self._real


def _greedy(model, params, tokens, steps, retrieve=None, feed=None):
    """prefill, the prefill caches loaded into decode caches of prompt +
    steps slots, then ``steps`` decode steps, step i consuming the argmax of
    the logits before it (greedy) or ``feed[i]`` when given (each step
    followed by ``retrieve(consumed token)`` when given).  Returns the
    prefill logits, per-step logits, the argmax after the prefill and after
    each step (``chosen``), the consumed tokens, the retrievals, and the
    per-step decode ms and retrieval ms by CUDA events."""
    B, S = tokens.shape
    logits, caches = lm_model.prefill(model, params, {"tokens": tokens})
    dec = lm_model.load_prefill_caches(
        lm_model.init_decode_caches(model, B, S + steps, device=tokens.device), caches)
    del caches
    out = dict(prefill=logits, logits=[], chosen=[logits.argmax(dim=-1)], fed=[], retrieved=[],
               decode_ms=[], retrieve_ms=[])
    for i in range(steps):
        tok = out["chosen"][i] if feed is None else feed[i].to(tokens.device)
        (step_logits, dec), ms, _ = _event_call(
            lambda: lm_model.decode_step(model, params, dec, tok, S + i))
        out["fed"].append(tok)
        out["logits"].append(step_logits)
        out["chosen"].append(step_logits.argmax(dim=-1))
        out["decode_ms"].append(ms)
        if retrieve is not None:
            got, ms, _ = _event_call(lambda: retrieve(tok))
            out["retrieved"].append(got)
            out["retrieve_ms"].append(ms)
    return out


def _reduced_card_vs_cpu(dev, dtype) -> dict:
    """The reduced Yi-6B config, prefill plus 8 greedy decode steps, on the
    card and by the port on the CPU, on the same weights; logits within
    LM_TOL at every step.  fp32: the card decodes greedily on its own and
    must choose the CPU's tokens.  bf16: the layers' outputs differ in the
    last bf16 bit (matmuls sum in another order), which can flip a near
    tie and send a free-running decode elsewhere, so the card consumes the
    CPU's greedy tokens, and its argmax must be the CPU's at every step
    whose top-2 gap on the CPU exceeds the bf16 bar (elsewhere it must be
    within the bar of the CPU's best); the free-running card decode's
    agreement is reported."""
    cfg = dataclasses.replace(lm_configs.get("yi-6b", reduced=True), dtype=str(dtype)[6:])
    model = lm_model.build(cfg)
    params = lm_model.init_params(model, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (LM_B, LM_REDUCED_PROMPT)))
    tol = LM_TOL[dtype]
    with torch.no_grad():
        cpu = _greedy(model, params, tokens, LM_REDUCED_STEPS)
        card_params = lm_model.tree_map(lambda t: t.to(dev), params)
        n0 = fa_kernel.launches
        free = _greedy(model, card_params, tokens.to(dev), LM_REDUCED_STEPS)
        launched = fa_kernel.launches - n0
        forced = free if dtype == torch.float32 else _greedy(
            model, card_params, tokens.to(dev), LM_REDUCED_STEPS, feed=cpu["fed"])
    want = [cpu["prefill"]] + cpu["logits"]
    got = [x.cpu() for x in [forced["prefill"]] + forced["logits"]]
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    close = all(torch.allclose(a, b, **tol) for a, b in zip(got, want))
    # per step: the CPU's top-2 gap, and whether the card chose the CPU's token
    steps = []
    for a, b, c in zip(got, want, forced["chosen"]):
        top2 = b.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1])
        bar = tol["atol"] + tol["rtol"] * top2[:, 0].abs()
        chosen_cpu = b.argmax(dim=-1)
        c = c.cpu()
        near = gap <= 2 * bar
        ok = (c == chosen_cpu) | (near & (b.gather(1, c[:, None])[:, 0] >= top2[:, 0] - 2 * bar))
        steps.append(dict(equal=int((c == chosen_cpu).sum()), near_ties=int(near.sum()),
                          ok=bool(ok.all()), min_gap=float(gap.min())))
    free_equal = sum(int((a.cpu() == b).all()) for a, b in zip(free["chosen"], cpu["chosen"]))
    r = dict(dtype=str(dtype)[6:], B=LM_B, prompt=LM_REDUCED_PROMPT, steps=LM_REDUCED_STEPS,
             logits_max_abs_err=max(errs), logits_err_by_step=errs, logits_close=close,
             choices=steps, free_running_steps_equal=free_equal,
             free_running_tokens_equal=free_equal == LM_REDUCED_STEPS + 1,
             flash_launches=launched)
    print("lm serve: reduced:", json.dumps(r))
    require(launched == cfg.n_layers, f"lm serve: the reduced prefill ({r['dtype']}) launched "
            f"flash_attention {launched} times, not once per layer ({cfg.n_layers})")
    require(close, f"lm serve: reduced Yi-6B ({r['dtype']}) on the card against the CPU: "
            f"logits max error by step {errs} (bar {tol})")
    require(all(st["ok"] for st in steps), f"lm serve: reduced Yi-6B ({r['dtype']}): the card's "
            f"greedy choices differ from the CPU's: {steps}")
    if dtype == torch.float32:
        require(r["free_running_tokens_equal"], "lm serve: reduced Yi-6B (float32): the card's "
                "greedy tokens differ from the CPU's")
    return r


def phase_lm_serve(dev, ds, graph, qb, card: str) -> dict:
    """The port's LM serving path on the card: the reduced Yi-6B config
    against the port on the CPU (fp32 and bf16), then Yi-6B at full width in
    bf16 serving 4 requests of 2 048 prompt tokens (prefill, the caches
    loaded into decode caches, 16 greedy decode steps, each retrieving top-5
    from phase 5's 10 000 x 128 index through velo.batch_search with the
    sampled token's embedding's first 128 dims as the query).  The full-width
    run's launch counts are read around it: one flash_attention launch per
    attention layer, each held against attention_ref on its own inputs."""
    out = dict(card=card, reduced=[_reduced_card_vs_cpu(dev, dt)
                                   for dt in (torch.float32, torch.bfloat16)])

    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    cfg = lm_configs.get("yi-6b")
    model = lm_model.build(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm_model.init_params(model, gen)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    sizes: list[int] = []
    lm_model.tree_map(lambda t: sizes.append(t.numel() * t.element_size()), params)
    out["weights_gb"] = sum(sizes) / 1e9
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_PROMPT), generator=gen, device=dev)
    index = velo_index.from_host(qb, graph, device=dev)

    def retrieve(tok):
        q = lm_layers.embed(tok, params["embed"]).float()[:, :ds.dim]
        return batch_search.batch_search(index, q, L=32, k=LM_TOPK)

    # the main path, counted: prefill (each flash launch checked), decode, retrieval
    reset_launches()
    with torch.no_grad(), FlashRecorder() as rec:
        run = _greedy(model, params, tokens, LM_STEPS, retrieve)
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    require(out["launches"]["flash_attention"] == n_attn and len(rec.errors) == n_attn,
            f"lm serve: a Yi-6B prefill must launch flash_attention once per attention layer "
            f"({n_attn}): {out['launches']}, {len(rec.errors)} checked")
    require(all(torch.isfinite(x).all() for x in [run["prefill"]] + run["logits"]),
            "lm serve: logits must be finite")
    toks = torch.stack(run["chosen"][1:], dim=1)
    require(toks.shape == (LM_B, LM_STEPS) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"lm serve: {LM_B} x {LM_STEPS} tokens must be produced: {tuple(toks.shape)}")
    for ids, d2, _ in run["retrieved"]:
        require(ids.shape == (LM_B, LM_TOPK) and bool(((ids >= 0) & (ids < len(ds.base))).all())
                and bool(torch.isfinite(d2).all()), "lm serve: retrieval output")
    out["flash_checked"] = dict(calls=len(rec.errors), max_abs_err=max(rec.errors),
                                shape=rec.shapes[0])
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["decode_ms"] = float(np.median(run["decode_ms"]))
    out["retrieve_ms"] = float(np.median(run["retrieve_ms"]))
    out["decode_tokens_per_s"] = LM_B / (out["decode_ms"] / 1e3)
    out["tokens"] = toks.cpu().tolist()
    out["retrieved_first_step"] = run["retrieved"][0][0].cpu().tolist()

    with torch.no_grad():
        # decode continues prefill: decode step 0 consumed the first greedy
        # token at position S from the S-token caches; the prefill over the
        # S + 1 tokens must predict the same next token
        first = run["fed"][0]
        full, _ = lm_model.prefill(model, params,
                                   {"tokens": torch.cat([tokens, first[:, None]], dim=1)})
        out["continue"] = dict(max_abs_dlogit=float((full - run["logits"][0]).abs().max()),
                               argmax_equal_share=float(
                                   (full.argmax(-1) == run["logits"][0].argmax(-1)).float().mean()),
                               max_abs_logit=float(full.abs().max()))
        del full
        out["prefill_ms"] = time_ms(lambda: lm_model.prefill(model, params, {"tokens": tokens}),
                                    reps=3, warmup=1)
        _, kernels, _ = _profile(lambda: lm_model.prefill(model, params, {"tokens": tokens}))
    total = sum(e.self_device_time_total for e in kernels)
    flash = sum(e.self_device_time_total for e in kernels if "flash_attention" in e.key)
    out["prefill_device_ms"] = total / 1e3
    out["flash_share"] = flash / total if total else None
    out["prefill_top"] = [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in kernels[:6]]
    out["prefill_tokens_per_s"] = LM_B * LM_PROMPT / (out["prefill_ms"] / 1e3)
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    print("lm serve:", json.dumps(out, default=float))
    return out


# ----------------------------------------------------------------- phase 11


# the reduced TinyLlama trained on the card and by the port on the CPU from
# the same weights: 5 steps of 4 x 64 tokens (AdamW, adamw8, AdamW with the
# int8 gradient compression); losses by dtype (fp32:
# the sums' order; bf16: phase 10's bar)
TRAIN_REDUCED = dict(B=4, S=64, steps=5, lr=1e-3)
OPT_STEPS = 3  # adamw8 updates on one gradient a step, card against the CPU
# adamw8's codes from the same gradients on two devices: equal but for at
# most 0.1 % off by one (tests/test_torch_train.py's bar)
CODE_BAR = dict(worst=1, share=1e-3)
# the share of parameters that the trained reduced adamw8 run may leave off
# the bulk bar, card against the CPU, in either dtype: the readings were
# 0.72 % (fp32) and 0.24 % (bf16), the same bits in every whole run on an
# H100 80GB HBM3 (PERF.md); the spread is the gradients' (see
# _adamw8_same_gradients)
ADAMW8_BULK = 1e-2
TRAIN_LOSS_TOL = {torch.float32: dict(rtol=1e-4, atol=0.0),
                  torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
BF16_ULP = 2.0 ** -7  # the spacing of bf16 values relative to their magnitude
GEMM_KEYS = ("gemm", "xmma", "nvjet", "cutlass")  # cuBLAS kernels by name


def adam_ratio_bound(b1: float, b2: float, t: int) -> float:
    """The largest |m_hat / sqrt(v_hat)| Adam can reach at step t over any
    gradients: with m_hat = sum w_i g_i and v_hat = sum u_i g_i^2,
    Cauchy-Schwarz gives sqrt(sum w_i^2 / u_i)."""
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return float(np.sqrt(sum(a * a / c for a, c in zip(w, u))))


def _train_batches(cfg, B: int, S: int, steps: int) -> list[dict]:
    dcfg = train_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    return [{k: torch.from_numpy(v) for k, v in train_data.batch_for_step(dcfg, s).items()}
            for s in range(steps)]


def _flash_per_step(cfg) -> int:
    """flash_attention launches in one train step: each attention layer's
    forward, and again when the backward recomputes its remat group."""
    return 2 * sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")


def _reduced_train_card_vs_cpu(dev, dtype, opt_name: str = "adamw",
                               compress: bool = False) -> dict:
    """The reduced TinyLlama, 5 steps of ``opt_name`` (``compress``: with the
    int8 gradient compression) on the card and by the port on the CPU from
    the same seeded weights and ``batch_for_step`` batches.
    Losses within TRAIN_LOSS_TOL.  Parameters: Adam moves an entry by about
    lr a step whatever |g|, so a gradient that nearly cancels can step the
    other way on one device, and no bar tighter than Adam's own worst case
    holds for every entry.  So every entry must lie within that worst case,
    2 sum_t lr_t R_t (R_t = adam_ratio_bound; plus, in bf16, one ulp of the
    entry a step for the parameters' rounding), and the bulk's summed
    updates must agree: fp32, all but 0.1 % of the entries within 1e-3 of
    sum_t lr_t (the total step); bf16, all but 1 % within 0.1 of it plus
    two ulps of the entry (an update of ~lr is one to ten ulps of these
    weights, so a last-bit difference in it can round the other way).
    adamw8 turns the devices' last-bit gradient differences into code
    flips, and a flipped code moves its entry's update by up to a code's
    width (``_adamw8_same_gradients`` shows it: fed the card's gradients,
    the CPU's update meets CODE_BAR and AdamW's bulk bar).  So
    adamw8's bulk is held to ADAMW8_BULK, set from the readings of two
    whole runs, and its trained codes are reported (``codes_off``)."""
    R = TRAIN_REDUCED
    cfg = dataclasses.replace(lm_configs.get("tinyllama-1.1b", reduced=True),
                              dtype=str(dtype)[6:])
    model = lm_model.build(cfg)
    opt_cfg = train_opt.OptConfig(lr=R["lr"], total_steps=R["steps"], warmup_steps=1)
    step_fn = train_step.make_train_step(model, opt_name, opt_cfg, ce_chunk=32,
                                         compress_grads=compress)
    cpu_p, cpu_o = train_step.make_init(model, opt_name)(torch.Generator().manual_seed(0))
    card_p, card_o = lm_model.tree_map(lambda t: t.to(dev), (cpu_p, cpu_o))
    tol = TRAIN_LOSS_TOL[dtype]
    cpu_l, card_l = [], []
    n0 = fa_kernel.launches
    for batch in _train_batches(cfg, R["B"], R["S"], R["steps"]):
        cpu_p, cpu_o, m = step_fn(cpu_p, cpu_o, batch)
        card_p, card_o, mc = step_fn(card_p, card_o, {k: v.to(dev) for k, v in batch.items()})
        cpu_l.append(float(m["loss"]))
        card_l.append(float(mc["loss"]))
    launched = fa_kernel.launches - n0
    lrs = [float(train_opt.schedule(opt_cfg, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, R["steps"] + 1)]
    b1, b2 = opt_cfg.betas
    worst = 2 * sum(lr * adam_ratio_bound(b1, b2, t) for t, lr in enumerate(lrs, 1))
    over, n_all, max_err = 0, 0, 0.0
    for a, b in zip(train_opt.tree_leaves(card_p), train_opt.tree_leaves(cpu_p)):
        a, b = a.float().cpu(), b.float()
        d = (a - b).abs()
        max_err = max(max_err, float(d.max()))
        if dtype == torch.float32:
            bound = worst + 1e-6 * b.abs().max()
        else:
            bound = worst + R["steps"] * BF16_ULP * torch.maximum(a.abs(), b.abs())
        over += int((d > bound).sum())
        n_all += d.numel()
    off = _bulk_off(card_p, cpu_p, lrs, dtype)
    loss_close = all(np.isclose(c, g, **tol) for c, g in zip(card_l, cpu_l))
    r = dict(dtype=str(dtype)[6:], opt=opt_name, compress_grads=compress, steps=R["steps"],
             cpu_losses=cpu_l, card_losses=card_l,
             loss_max_rel_err=max(abs(c - g) / abs(g) for c, g in zip(card_l, cpu_l)),
             params_max_abs_err=max_err, adam_worst_case=worst, entries_over_worst_case=over,
             entries_off_bulk=off, entries=n_all, off_share=off / n_all, flash_launches=launched)
    if opt_name == "adamw8":
        r["codes_off"] = {k: _codes_off(card_o[k], cpu_o[k]) for k in "mv"}
    tag = f"lm train: reduced ({r['dtype']}, {opt_name}{', compressed' if compress else ''})"
    print(tag + ":", json.dumps(r))
    per_step = _flash_per_step(cfg)
    require(launched == per_step * R["steps"], f"{tag} launched flash_attention {launched} "
            f"times, not {per_step} a step")
    require(loss_close, f"{tag}: card losses {card_l} against the CPU's {cpu_l} (bar {tol})")
    require(over == 0, f"{tag}: {over} parameters beyond Adam's worst case {worst:.3e}")
    bulk = ADAMW8_BULK if opt_name == "adamw8" else (1e-3 if dtype == torch.float32 else 1e-2)
    require(r["off_share"] <= bulk, f"{tag}: {off} of {n_all} parameters off the CPU's")
    return r


def _bulk_off(got, want, lrs: list, dtype) -> int:
    """Parameters of two trees farther apart than the bulk bar of
    ``_reduced_train_card_vs_cpu`` after the steps of ``lrs``."""
    off = 0
    for a, b in zip(train_opt.tree_leaves(got), train_opt.tree_leaves(want)):
        a, b = a.float().cpu(), b.float().cpu()
        if dtype == torch.float32:
            off += int(((a - b).abs() > 1e-3 * sum(lrs) + 1e-6 * b.abs()).sum())
        else:
            off += int(((a - b).abs() > 0.1 * sum(lrs) + 2 * BF16_ULP * b.abs()).sum())
    return off


def _adamw8_same_gradients(dev, dtype) -> dict:
    """Where the trained adamw8 run's spread comes from.  The reduced
    TinyLlama's run of ``_reduced_train_card_vs_cpu`` on the card, as the
    step's two halves (``loss_and_grads``, then ``adamw8_update``), beside
    the CPU's ``adamw8_update`` fed the card's gradients every step from the
    same start: the two differ only by the update's arithmetic, and are held
    to CODE_BAR and AdamW's bulk bar (fp32 0.1 %, bf16 1 %).  Each step also
    reports the gradients' distance, the card's against the CPU's at the card's parameters, and
    the codes which that difference alone moves: the CPU's update from the
    card's state with either gradient."""
    R = TRAIN_REDUCED
    cfg = dataclasses.replace(lm_configs.get("tinyllama-1.1b", reduced=True),
                              dtype=str(dtype)[6:])
    model = lm_model.build(cfg)
    opt_cfg = train_opt.OptConfig(lr=R["lr"], total_steps=R["steps"], warmup_steps=1)
    fed_p, fed_s = train_step.make_init(model, "adamw8")(torch.Generator().manual_seed(0))
    card_p, card_s = lm_model.tree_map(lambda t: t.to(dev), (fed_p, fed_s))
    steps = []
    for batch in _train_batches(cfg, R["B"], R["S"], R["steps"]):
        _, g = train_step.loss_and_grads(model, card_p, {k: v.to(dev) for k, v in batch.items()},
                                         ce_chunk=32)
        g = [t.cpu() for t in g]
        at_p, at_s = lm_model.tree_map(lambda t: t.cpu(), (card_p, card_s))
        _, g_cpu = train_step.loss_and_grads(model, at_p, batch, ce_chunk=32)
        _, with_card, _ = train_opt.adamw8_update(at_p, train_opt.tree_unflatten(at_p, g),
                                                  at_s, opt_cfg)
        _, with_cpu, _ = train_opt.adamw8_update(at_p, train_opt.tree_unflatten(at_p, g_cpu),
                                                 at_s, opt_cfg)
        card_p, card_s, _ = train_opt.adamw8_update(
            card_p, train_opt.tree_unflatten(card_p, [t.to(dev) for t in g]), card_s, opt_cfg)
        fed_p, fed_s, _ = train_opt.adamw8_update(fed_p, train_opt.tree_unflatten(fed_p, g),
                                                  fed_s, opt_cfg)
        diff = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(g, g_cpu))
        norm = sum(float(b.double().square().sum()) for b in g_cpu)
        steps.append(dict(grad_rel_dist=(diff / norm) ** 0.5,
                          codes_moved_by_grads={k: _codes_off(with_card[k], with_cpu[k])
                                                for k in "mv"}))
    lrs = [float(train_opt.schedule(opt_cfg, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, R["steps"] + 1)]
    n_all = sum(t.numel() for t in train_opt.tree_leaves(fed_p))
    r = dict(dtype=str(dtype)[6:], steps=steps,
             codes_off={k: _codes_off(card_s[k], fed_s[k]) for k in "mv"},
             off_share=_bulk_off(card_p, fed_p, lrs, dtype) / n_all)
    print(f"lm train: reduced ({r['dtype']}, adamw8) fed the card's gradients:", json.dumps(r))
    require(all(c["worst"] <= CODE_BAR["worst"] and c["share"] <= CODE_BAR["share"]
                for c in r["codes_off"].values()),
            f"lm train: adamw8 on the card off the CPU's fed the same gradients: {r}")
    require(r["off_share"] <= (1e-3 if dtype == torch.float32 else 1e-2),
            f"lm train: adamw8's parameters on the card off the CPU's fed the same gradients: {r}")
    return r


def _codes_off(got, want) -> dict:
    """adamw8 state trees (either device): the largest difference of their
    int8 codes and the share of codes that differ."""
    pairs = [(a.cpu().int(), b.cpu().int()) for a, b in zip(train_opt.tree_leaves(got),
                                                            train_opt.tree_leaves(want))
             if a.dtype == torch.int8]
    return dict(worst=max(int((a - b).abs().max()) for a, b in pairs),
                share=sum(int((a != b).sum()) for a, b in pairs) / sum(a.numel() for a, _ in pairs))


def _opt_one_gradient(dev, dtype) -> dict:
    """adamw8's update and the int8 gradient compression on the card against
    the CPU on one gradient: the reduced TinyLlama's seeded weights and
    OPT_STEPS seeded gradients (N(0, 1e-2), the weights' dtype), no
    clipping.  adamw8's state: codes to CODE_BAR (the card's exp and log
    may round a last bit apart).  The compression (``Opt._q8`` of each
    gradient: a max, a true division and a rounding): codes and scales
    bitwise the CPU's."""
    cfg = dataclasses.replace(lm_configs.get("tinyllama-1.1b", reduced=True),
                              dtype=str(dtype)[6:])
    params, state = train_step.make_init(lm_model.build(cfg), "adamw8")(
        torch.Generator().manual_seed(0))
    opt_cfg = train_opt.OptConfig(lr=TRAIN_REDUCED["lr"], total_steps=OPT_STEPS,
                                  warmup_steps=1, grad_clip=1e9)
    gen = torch.Generator().manual_seed(4)
    card_p, card_s = lm_model.tree_map(lambda t: t.to(dev), (params, state))
    compressed = {"card": [], "cpu": []}
    for _ in range(OPT_STEPS):
        grads = lm_model.tree_map(lambda t: (1e-2 * torch.randn(t.shape, generator=gen))
                                  .to(t.dtype), params)
        card_g = lm_model.tree_map(lambda t: t.to(dev), grads)
        params, state, _ = train_opt.adamw8_update(params, grads, state, opt_cfg)
        card_p, card_s, _ = train_opt.adamw8_update(card_p, card_g, card_s, opt_cfg)
        for key, tree in (("card", card_g), ("cpu", grads)):
            compressed[key] += [train_opt._q8(g.float()) for g in train_opt.tree_leaves(tree)]
    r = dict(dtype=str(dtype)[6:], steps=OPT_STEPS,
             codes_off={k: _codes_off(card_s[k], state[k]) for k in "mv"},
             params_max_abs_err=max(float((a.cpu().float() - b.float()).abs().max()) for a, b in
                                    zip(train_opt.tree_leaves(card_p),
                                        train_opt.tree_leaves(params))),
             compress_codes_off=_codes_off(compressed["card"], compressed["cpu"]),
             compress_scales_differ=sum(int((a[1].cpu() != b[1]).sum())
                                        for a, b in zip(compressed["card"], compressed["cpu"])))
    print("lm train: one gradient:", json.dumps(r))
    require(all(c["worst"] <= CODE_BAR["worst"] and c["share"] <= CODE_BAR["share"]
                for c in r["codes_off"].values()),
            f"lm train: adamw8's codes on the card off the CPU's on one gradient: {r}")
    require(r["compress_codes_off"]["worst"] == 0 and r["compress_scales_differ"] == 0,
            f"lm train: the compression on the card not bitwise the CPU's: {r}")
    return r


def _range_kernels(ev) -> list:
    """The kernels launched under a profiled CPU event and its children."""
    out = list(ev.kernels)
    for ch in ev.cpu_children:
        out += _range_kernels(ch)
    return out


def _train_split(prof) -> dict:
    """A profiled train step's device time (ms): the cuBLAS GEMMs (outside
    the attention backward), flash_attention, the plain attention backward
    (everything under ``chunked_attention.backward``), the optimizer
    (everything under ``train_step.optimizer``) and the rest."""
    ranges = {"chunked_attention.backward": [0.0, 0.0, 0], "train_step.optimizer": [0.0, 0.0, 0]}
    # the ranges also show as device-side annotations: kernels are the rest
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in ranges
               and not e.key.startswith(("Memcpy", "Memset"))]

    def is_gemm(name):
        return any(k in name.lower() for k in GEMM_KEYS)

    def us(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key))

    total, flash, gemm = us(lambda k: True), us(lambda k: "flash_attention" in k), us(is_gemm)
    for ev in prof.events():
        if ev.name in ranges and ev.device_type == DeviceType.CPU:
            ks = _range_kernels(ev)
            ranges[ev.name][0] += sum(k.duration for k in ks)
            ranges[ev.name][1] += sum(k.duration for k in ks if is_gemm(k.name))
            ranges[ev.name][2] += 1
    bwd, bwd_gemm, n_bwd = ranges["chunked_attention.backward"]
    opt, _, _ = ranges["train_step.optimizer"]
    split = dict(total_ms=total / 1e3, gemm_ms=(gemm - bwd_gemm) / 1e3, flash_ms=flash / 1e3,
                 attention_backward_ms=bwd / 1e3, attention_backward_gemm_ms=bwd_gemm / 1e3,
                 attention_backward_ranges=n_bwd, optimizer_ms=opt / 1e3)
    split["other_ms"] = (total - (gemm - bwd_gemm) - flash - bwd - opt) / 1e3
    split["launches"] = sum(e.count for e in kernels)
    split["top"] = [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in
                    sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]]
    return split


def _plain_backward_ms(dev) -> float:
    """The attention backward's time for one layer at the training call:
    the streaming recurrence recomputed under autograd and differentiated,
    as ``FlashAttention.backward`` does (CUDA events, median of 5)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    H, KVH, Dh = TINYLLAMA["H"], TINYLLAMA["KVH"], TINYLLAMA["Dh"]
    q, grad = (torch.randn(TRAIN_B, H, TRAIN_S, Dh, generator=gen, device=dev).bfloat16()
               for _ in range(2))
    k, v = (torch.randn(TRAIN_B, KVH, TRAIN_S, Dh, generator=gen, device=dev).bfloat16()
            for _ in range(2))

    def backward():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = lm_layers._streaming_attention(*ins, True, 0, 512, None)
            return torch.autograd.grad(out, ins, grad)

    return time_ms(backward, reps=5, warmup=1)


def _cli_resume(card: str) -> dict:
    """``launch.train`` on the card (its defaults: the reduced TinyLlama, 8 x
    128 tokens): 12 steps uninterrupted; then with a failure injected at
    step 6 (exit 42) after the step-4 checkpoint, and ``--resume`` to the
    end.  The resumed losses must equal the uninterrupted run's within
    1e-6 relative; whether they and the final checkpoints are bitwise equal
    is reported."""
    root = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", "tinyllama-1.1b", "--steps", "12", "--ckpt-every", "4",
            "--log-every", "4", "--device", "cuda"]
    reset_launches()
    t0 = time.perf_counter()
    full = train_cli.main(argv + ["--ckpt-dir", str(root / "full")])
    code = 0
    try:
        train_cli.main(argv + ["--ckpt-dir", str(root / "cut"), "--fail-at-step", "6"])
    except SystemExit as exc:
        code = exc.code
    resumed = train_cli.main(argv + ["--ckpt-dir", str(root / "cut"), "--resume"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    with np.load(root / "full" / "step_00000012" / "arrays.npz") as a, \
            np.load(root / "cut" / "step_00000012" / "arrays.npz") as b:
        same_files = a.files == b.files
        ckpt_bitwise = same_files and all(np.array_equal(a[k], b[k]) for k in a.files)
    shutil.rmtree(root)
    r = dict(exit_code=code, full_losses=full, resumed_losses=resumed,
             max_rel_err=max(abs(x - y) / abs(y) for x, y in zip(resumed, full[4:])),
             losses_bitwise=resumed == full[4:], checkpoint_bitwise=ckpt_bitwise,
             wall_s=wall, launches=launches)
    print(f"lm train: CLI on {card}:", json.dumps(r))
    require(code == 42, f"lm train: the CLI's injected failure exited {code}, not 42")
    require(len(resumed) == 8 and same_files and r["max_rel_err"] <= 1e-6,
            f"lm train: the resumed CLI run differs from the uninterrupted one: {r}")
    return r


def _full_width_train(dev, opt_name: str, steps: int) -> dict:
    """TinyLlama-1.1B at its published widths in bf16, ``steps`` steps of
    ``opt_name`` on 4 x 2 048 tokens (``batch_for_step``, seed 0), then a
    profiled step on the first batch again, whose loss must be below the
    first step's: the first step's flash launches each held against
    attention_ref, step ms by CUDA events (median after the first step),
    peak memory, the profiled step's device split.  The launch counters
    are set to 0 before the steps and read after them."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = lm_configs.get("tinyllama-1.1b")
    model = lm_model.build(cfg)
    per_step = _flash_per_step(cfg)
    opt_cfg = train_opt.OptConfig(lr=3e-4, total_steps=steps, warmup_steps=1)
    step_fn = train_step.make_train_step(model, opt_name, opt_cfg)
    out = dict(opt=opt_name)
    t0 = time.perf_counter()
    params, opt = train_step.make_init(model, opt_name)(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0

    def gb(tree):
        return sum(t.numel() * t.element_size() for t in train_opt.tree_leaves(tree)) / 1e9

    out["params_gb"], out["opt_gb"] = gb(params), gb(opt)
    batches = _train_batches(cfg, TRAIN_B, TRAIN_S, steps)
    losses, ms, launched = [], [], []
    reset_launches()  # the main path, counted
    for step, batch in enumerate(batches):
        batch = {k: v.to(dev) for k, v in batch.items()}
        n0 = fa_kernel.launches
        if step == 0:
            with FlashRecorder(f"lm train {opt_name}") as rec:
                (params, opt, m), t, _ = _event_call(lambda: step_fn(params, opt, batch))
        else:
            (params, opt, m), t, _ = _event_call(lambda: step_fn(params, opt, batch))
        launched.append(fa_kernel.launches - n0)
        losses.append(float(m["loss"]))
        ms.append(t)
    out["launches"] = read_launches()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(losses=losses, step_ms_each=ms, flash_launches_per_step=launched,
               flash_checked=dict(calls=len(rec.errors), max_abs_err=max(rec.errors),
                                  shape=rec.shapes[0]))
    out["step_ms"] = float(np.median(ms[1:]))
    out["tokens_per_s"] = TRAIN_B * TRAIN_S / (out["step_ms"] / 1e3)
    print(f"lm train: TinyLlama-1.1B {opt_name} losses", losses, "step ms", ms, flush=True)
    require(all(np.isfinite(losses)), f"lm train ({opt_name}): losses must be finite: {losses}")
    require(steps <= 3 or np.mean(losses[-3:]) < losses[0],
            f"lm train ({opt_name}): the mean of the last 3 losses must be below the first: "
            f"{losses}")
    require(all(n == per_step for n in launched) and len(rec.errors) == per_step,
            f"lm train ({opt_name}): each step must launch flash_attention {per_step} times "
            f"(forward and remat recompute of {per_step // 2} attention layers): {launched}, "
            f"{len(rec.errors)} checked")

    from torch.profiler import ProfilerActivity, profile

    batch = {k: v.to(dev) for k, v in batches[0].items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
    out["first_batch_loss_after"] = float(m["loss"])
    out["split"] = _train_split(prof)
    out["optimizer_share"] = out["split"]["optimizer_ms"] / out["split"]["total_ms"]
    require(out["first_batch_loss_after"] < losses[0],
            f"lm train ({opt_name}): the first batch's loss after {steps} steps, "
            f"{out['first_batch_loss_after']}, must be below the first step's {losses[0]}")
    del prof, params, opt, batch, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_lm_train(dev, card: str) -> dict:
    """The port's training path on the card: the reduced TinyLlama against
    the port on the CPU (fp32 and bf16; AdamW, adamw8 and AdamW with the
    int8 gradient compression), adamw8's update and the compression on one
    gradient against the CPU, then TinyLlama-1.1B at its published widths
    in bf16: 10 AdamW steps and 3 adamw8 steps of 4 x 2 048 tokens
    (``_full_width_train``), each attention layer's forward on the
    flash_attention kernel and its backward the streaming recurrence's.
    Every step launches the kernel twice per attention layer: in the
    forward and again in the remat recompute of its group during the
    backward.  Then the training CLI resumed after an injected failure."""
    out = dict(card=card, reduced=[_reduced_train_card_vs_cpu(dev, dt, opt, compress)
                                   for dt in (torch.float32, torch.bfloat16)
                                   for opt, compress in (("adamw", False), ("adamw8", False),
                                                         ("adamw", True))],
               same_gradients=[_adamw8_same_gradients(dev, dt)
                               for dt in (torch.float32, torch.bfloat16)],
               one_gradient=[_opt_one_gradient(dev, dt)
                             for dt in (torch.float32, torch.bfloat16)])
    out.update(_full_width_train(dev, "adamw", TRAIN_STEPS))
    out["plain_backward_ms_a_layer"] = _plain_backward_ms(dev)
    out["adamw8"] = _full_width_train(dev, "adamw8", ADAMW8_STEPS)
    out["cli"] = _cli_resume(card)
    gc.collect()
    torch.cuda.empty_cache()
    print("lm train:", json.dumps({k: v for k, v in out.items()
                                   if k not in ("reduced", "same_gradients", "one_gradient")},
                                  default=float))
    return out

# ----------------------------------------------------------------- phase 12


# the lm shard phase: the mesh (models.sharding, launch.mesh) in a one-rank
# NCCL group on the card; dbrx-132b's MoE layer at its published widths
# (src/repro/configs/dbrx_132b.py: 16 experts top-4, d 6 144, d_ff 10 752,
# bf16), 4 096 tokens
SHARD_TRAIN_STEPS, SHARD_MICROBATCHES = 3, 2
MOE_TOKENS = 4096
# the dry run beside the card, in a child process (a fake group of 1 for
# phase 11's own batch, then one of 256 for the reference's test cell)
DRYRUN_CHILD = r"""
import json, sys, time
sys.path.insert(0, "src")
from repro_torch.launch import dryrun, mesh as mesh_mod, roofline, shapes
B, S = int(sys.argv[1]), int(sys.argv[2])
batch = {"tokens": shapes.S((B, S), shapes.I32), "labels": shapes.S((B, S), shapes.I32)}
cell = shapes.CellSpec(kind="train", batch=batch, seq_len=S, global_batch=B)
t0 = time.time()
rec = dryrun.run_lm_cell("tinyllama-1.1b", "phase11", False, 1, cell=cell,
                         mesh=mesh_mod.Mesh((1, 1), ("data", "model")))
rec["wall_s"] = time.time() - t0
rec["roofline"] = roofline.analyze(rec)
print(json.dumps(rec))
t0 = time.time()
rec = dryrun.run_and_save("rwkv6-7b", "long_500k", False)
rec["wall_s"] = time.time() - t0
print(json.dumps(rec))
"""


def _nccl_mesh(dev):
    """A one-rank NCCL process group on the card and its (data 1, model 1)
    DeviceMesh, armed as the models' active mesh."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import sharding as Sh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    mesh = mesh_mod.Mesh((1, 1), ("data", "model"))
    dmesh = mesh_mod.device_mesh(mesh, "cuda")
    Sh.set_active_mesh(dmesh, dp_axes=mesh_mod.dp_axes(mesh))
    for axis in mesh.axis_names:  # bring each group's communicator up before timing
        Sh.all_reduce(torch.ones(1, device=dev), axis)
    torch.cuda.synchronize()
    return dmesh


def _shard_serve(dev, dmesh, want_tokens) -> dict:
    """Yi-6B at full width (phase 10's seeded weights and prompts), params
    placed by ``param_pspecs``, decode caches by ``cache_pspecs``: prefill
    (32 flash launches) and 16 greedy decode steps, tokens against phase
    10's."""
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as Sh

    cfg = lm_configs.get("yi-6b")
    model = lm_model.build(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm_model.init_params(model, gen)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_PROMPT), generator=gen, device=dev)
    specs, degraded = Sh.check_divisible(params, Sh.param_pspecs(params), dmesh)
    placed = Sh.place(params, dmesh, Sh.named(dmesh, specs))

    def put(t):
        return Sh.place(t, dmesh, Sh.batch_placements(dmesh, t.shape[0], t.dim()))

    out = dict(degraded=degraded)
    with torch.no_grad():
        n0 = fa_kernel.launches
        (logits, pc), out["prefill_ms"], _ = _event_call(
            lambda: lm_model.prefill(model, placed, {"tokens": put(tokens)}))
        out["prefill_flash_launches"] = fa_kernel.launches - n0
        caches = lm_model.init_decode_caches(model, LM_B, LM_PROMPT + LM_STEPS, device=dev)
        cspecs = dryrun.cache_pspecs(model, caches, Sh.dp_axes(), LM_PROMPT + LM_STEPS)
        caches = lm_model.load_prefill_caches(Sh.place(caches, dmesh, Sh.named(dmesh, cspecs)),
                                              pc, model)
        del pc
        tok, toks, ms = logits.argmax(-1), [], []
        for i in range(LM_STEPS):
            (logits, caches), t, _ = _event_call(
                lambda: lm_model.decode_step(model, placed, caches, put(tok), LM_PROMPT + i))
            tok = logits.argmax(-1)
            toks.append(tok)
            ms.append(t)
    got = torch.stack(toks, dim=1).cpu().tolist()
    out.update(tokens_equal=got == want_tokens, decode_ms=float(np.median(ms)),
               tokens=got)
    del params, placed, caches
    return out


def _shard_train(dev, dmesh, unsharded_ms: float, opt_name: str = "adamw",
                 compress: bool = False) -> dict:
    """TinyLlama-1.1B at full width (phase 11's seeded weights and batches,
    4 x 2 048 tokens; ``opt_name``, ``compress``: with the int8 gradient
    compression): 3 steps of 2 microbatches through the sharded step
    (``grad_pspecs``, ``batch_shardings``, the state placed by
    ``opt_state_placements``) against the unsharded step on the same
    weights."""
    from repro_torch.models import sharding as Sh

    cfg = lm_configs.get("tinyllama-1.1b")
    model = lm_model.build(cfg)
    opt_cfg = train_opt.OptConfig(lr=3e-4, total_steps=TRAIN_STEPS, warmup_steps=1)
    p0, o0 = train_step.make_init(model, opt_name)(torch.Generator(device=dev).manual_seed(0))
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in _train_batches(cfg, TRAIN_B, TRAIN_S, SHARD_TRAIN_STEPS)]
    specs, _ = Sh.check_divisible(p0, Sh.param_pspecs(p0), dmesh)
    pl = Sh.named(dmesh, specs)
    sp = Sh.place(p0, dmesh, pl)
    so = Sh.place(o0, dmesh, train_step.opt_state_placements(opt_name, o0, pl, dmesh))
    sstep = train_step.make_train_step(
        model, opt_name, opt_cfg, microbatches=SHARD_MICROBATCHES, compress_grads=compress,
        grad_pspecs=pl,
        batch_shardings=lambda nd: Sh.batch_placements(dmesh, TRAIN_B // SHARD_MICROBATCHES, nd))
    losses, ms, launched = [], [], []
    for b in batches:
        n0 = fa_kernel.launches
        (sp, so, m), t, _ = _event_call(lambda: sstep(sp, so, {
            k: Sh.place(v, dmesh, Sh.batch_placements(dmesh, v.shape[0], v.dim()))
            for k, v in b.items()}))
        launched.append(fa_kernel.launches - n0)
        losses.append(float(m["loss"]))
        ms.append(t)
    sharded = [t.to_local() for t in train_opt.tree_leaves(sp)]
    sharded_state = [t.to_local() if hasattr(t, "to_local") else t
                     for t in train_opt.tree_leaves(so)]
    del so
    # the unsharded step on the same weights and batches, outside the mesh
    Sh.clear_active_mesh()
    step = train_step.make_train_step(model, opt_name, opt_cfg, microbatches=SHARD_MICROBATCHES,
                                      compress_grads=compress)
    p, o, ref, ref_ms = p0, o0, [], []
    for b in batches:
        (p, o, m), t, _ = _event_call(lambda: step(p, o, b))
        ref.append(float(m["loss"]))
        ref_ms.append(t)
    Sh.set_active_mesh(dmesh, dp_axes=("data",))
    # phase 11's bar where not bitwise: every entry within Adam's worst case
    lrs = [float(train_opt.schedule(opt_cfg, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, SHARD_TRAIN_STEPS + 1)]
    b1, b2 = opt_cfg.betas
    worst = 2 * sum(lr * adam_ratio_bound(b1, b2, t) for t, lr in enumerate(lrs, 1))
    diffs, over = [], 0
    for a, b in zip(sharded, train_opt.tree_leaves(p)):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        diffs.append(float(d.max()))
        over += int((d > worst + SHARD_TRAIN_STEPS * BF16_ULP * torch.maximum(a.abs(), b.abs()))
                    .sum())
    out = dict(opt=opt_name, compress_grads=compress, losses=losses, unsharded_losses=ref,
               losses_bitwise=losses == ref,
               loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in zip(losses, ref)),
               params_bitwise=max(diffs) == 0.0, params_max_abs_err=max(diffs),
               state_bitwise=all(torch.equal(a, b) for a, b in zip(
                   sharded_state, train_opt.tree_leaves(o))),
               adam_worst_case=worst, entries_over_worst_case=over,
               flash_launches_per_step=launched, step_ms_each=ms,
               step_ms=float(np.median(ms[1:])), unsharded_step_ms=float(np.median(ref_ms[1:])),
               phase11_step_ms=unsharded_ms)
    del sp, p, o, p0, o0, sharded, sharded_state
    return out


def _shard_moe(dev, dmesh) -> dict:
    """One dbrx-132b MoE layer at full width on 4 096 tokens: ``moe_ffn_ep``
    under the mesh against ``moe_ffn``, on the same seeded weights."""
    from repro_torch.models import moe
    from repro_torch.models import sharding as Sh

    cfg = lm_configs.get("dbrx-132b")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = moe.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_shared_experts,
                     torch.bfloat16)
    x = torch.randn(MOE_TOKENS, cfg.d_model, generator=gen, device=dev).bfloat16()
    tree = {"moe": p}
    specs, _ = Sh.check_divisible(tree, Sh.param_pspecs(tree), dmesh)
    placed = Sh.place(tree, dmesh, Sh.named(dmesh, specs))["moe"]
    with torch.no_grad():  # each timed on its second call
        for _ in range(2):
            (ep, aux_ep), ep_ms, _ = _event_call(
                lambda: moe.moe_ffn_ep(placed, x, cfg.moe_top_k, cfg.capacity_factor))
        Sh.clear_active_mesh()
        for _ in range(2):
            (ref, aux), ref_ms, _ = _event_call(
                lambda: moe.moe_ffn(p, x, cfg.moe_top_k, cfg.capacity_factor))
        Sh.set_active_mesh(dmesh, dp_axes=("data",))
    out = dict(expert_gb=sum(p[k].numel() * 2 for k in ("w_gate", "w_up", "w_down")) / 1e9,
               equal=bool(torch.equal(ep, ref)) and float(aux_ep) == float(aux),
               max_abs_err=float((ep.float() - ref.float()).abs().max()),
               ep_ms=ep_ms, moe_ffn_ms=ref_ms, finite=bool(torch.isfinite(ep.float()).all()))
    del p, placed, x, ep, ref
    return out


def _dryrun_beside(train: dict) -> dict:
    """The dry run's prediction for phase 11's batch at the 1 x 1 mesh beside
    phase 11's measurement, and the reference's test cell on 256 fake ranks
    (a child process: the dry run's group is a fake one)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DRYRUN_CHILD, str(TRAIN_B), str(TRAIN_S)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"lm shard: the dry run failed: {proc.stderr[-2000:]}")
    cell, prod = (json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{"))
    cfg = lm_configs.get("tinyllama-1.1b")
    n_active = cfg.active_params_count()
    step_s = train["step_ms"] / 1e3
    out = dict(wall_s=time.perf_counter() - t0,
               predicted=dict(peak_gib=cell["memory"]["peak_estimate_bytes"] / 2**30,
                              argument_gib=cell["memory"]["argument_bytes"] / 2**30,
                              step_flops=cell["cost"]["flops_per_device"],
                              model_flops=cell["roofline"]["model_flops_per_device"],
                              t_compute_s=cell["roofline"]["t_compute_s"],
                              t_memory_s=cell["roofline"]["t_memory_s"],
                              t_collective_s=cell["roofline"]["t_collective_s"],
                              dominant=cell["roofline"]["dominant"], trace_wall_s=cell["wall_s"]),
               measured=dict(peak_gib=train["peak_gb"] * 1e9 / 2**30, step_s=step_s,
                             mfu=6 * n_active * TRAIN_B * TRAIN_S / step_s / BF16_FLOP_PER_S,
                             flops_per_s_at_predicted=cell["cost"]["flops_per_device"] / step_s),
               production=dict(status=prod["status"], n_devices=prod.get("n_devices"),
                               flops_per_device=prod.get("cost", {}).get("flops_per_device"),
                               peak_gib=prod.get("memory", {}).get("peak_estimate_bytes", 0)
                               / 2**30, wall_s=prod["wall_s"]))
    require(cell["status"] == "ok", f"lm shard: the 1 x 1 dry-run cell: {cell.get('error')}")
    p = out["production"]
    require(p["status"] == "ok" and p["n_devices"] == 256 and p["flops_per_device"] > 0
            and p["peak_gib"] < 80, f"lm shard: the rwkv6-7b long_500k pod1 cell: {p}")
    return out


def phase_lm_shard(dev, card: str, lm: dict, train: dict) -> dict:
    """The mesh on the card: a one-rank NCCL group and a (data 1, model 1)
    mesh; Yi-6B served under it (tokens equal to phase 10's, 32 flash
    launches a prefill); TinyLlama-1.1B trained through the sharded step
    against the unsharded one (44 flash launches a microbatch); one dbrx MoE
    layer through ``moe_ffn_ep`` against ``moe_ffn``; the dry run's
    prediction beside phase 11's measurement, and a production cell."""
    import torch.distributed as dist

    from repro_torch.models import sharding as Sh

    gc.collect()
    torch.cuda.empty_cache()
    out = dict(card=card)
    dmesh = _nccl_mesh(dev)
    try:
        reset_launches()  # the main path, counted
        out["serve"] = _shard_serve(dev, dmesh, lm["tokens"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["train"] = _shard_train(dev, dmesh, train["step_ms"])
        out["train"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for key, opt, compress in (("train_adamw8", "adamw8", False),
                                   ("train_compress", "adamw", True)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out[key] = _shard_train(dev, dmesh, train["step_ms"], opt, compress)
            out[key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["launches"] = read_launches()
        gc.collect()
        torch.cuda.empty_cache()
        out["moe"] = _shard_moe(dev, dmesh)
    finally:
        Sh.clear_active_mesh()
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["dryrun"] = _dryrun_beside(train)
    print("lm shard:", json.dumps(out, default=float))
    sv, tr, mo = out["serve"], out["train"], out["moe"]
    n_attn = sum(1 for i in range(lm_configs.get("yi-6b").n_layers)
                 if lm_configs.get("yi-6b").layer_kind(i) == "attn")
    require(sv["prefill_flash_launches"] == n_attn,
            f"lm shard: the Yi-6B prefill under the mesh launched flash_attention "
            f"{sv['prefill_flash_launches']} times, not {n_attn}")
    require(sv["tokens_equal"], "lm shard: Yi-6B's greedy tokens under the mesh differ from "
            "phase 10's")
    per_mb = _flash_per_step(lm_configs.get("tinyllama-1.1b"))
    tol = TRAIN_LOSS_TOL[torch.bfloat16]
    for key in ("train", "train_adamw8", "train_compress"):
        tr = out[key]
        tag = f"lm shard ({tr['opt']}{', compressed' if tr['compress_grads'] else ''})"
        require(all(n == per_mb * SHARD_MICROBATCHES for n in tr["flash_launches_per_step"]),
                f"{tag}: each sharded step must launch flash_attention {per_mb} times a "
                f"microbatch: {tr['flash_launches_per_step']}")
        require(all(np.isfinite(tr["losses"])) and all(
            np.isclose(a, b, **tol) for a, b in zip(tr["losses"], tr["unsharded_losses"])),
            f"{tag}: sharded losses {tr['losses']} against {tr['unsharded_losses']}")
        require(tr["params_bitwise"] or tr["entries_over_worst_case"] == 0,
                f"{tag}: {tr['entries_over_worst_case']} sharded parameters beyond Adam's "
                f"worst case off the unsharded step's")
    require(mo["equal"] and mo["finite"], f"lm shard: moe_ffn_ep differs from moe_ffn: "
            f"{mo['max_abs_err']}")
    return out


# ----------------------------------------------------------------- phase 13


# the torch twins of the reference's examples, each its own process on the
# card (``chip_smoke.py --example NAME``: the twin's own main with no
# arguments, so on the card), the three side by side: each is host-bound
# (its Vamana build) and the machine has cores to spare.  The kernels each
# must launch; distributed_search's scan launches binary_ip alone.
EXAMPLES = {"quickstart_torch": ("binary_ip", "int4_dist"),
            "serve_batch_torch": ("binary_ip", "int4_dist"),
            "distributed_search_torch": ("binary_ip",)}
EXAMPLE_TIMEOUT_S = 600
EXAMPLE_LOGS = ROOT / "build" / "examples"
KEPT_EVERY = 4  # a twin keeps the inputs of calls 1, 4, 16, ... of each kernel entry
# the kernel entries the wrappers launch through, by kernel
ENTRIES = ((bip_kernel, "binary_ip_cuda", "binary_ip"),
           (bip_kernel, "estimate_dist2_cuda", "binary_ip"),
           (i4_kernel, "int4_dist_cuda", "int4_dist"))


def _plain_of(entry: str, args: tuple) -> torch.Tensor:
    """The plain version of a kernel entry's call, on the same tensors."""
    q, codes, *tables, ids = args
    rows = [codes, *tables] if ids is None else [t[ids] for t in (codes, *tables)]
    if entry == "binary_ip_cuda":
        return bip_ref.binary_ip_ref(q, *rows)
    if entry == "estimate_dist2_cuda":
        return bip_ref.estimate_dist2_ref(q, *rows)
    return i4_ref.int4_dist2_ref(q, *rows)


def _observed(run, name: str) -> None:
    """Runs ``run`` (a twin's main path) with the kernels observed: the
    launch counters set to 0 just before it and read just after; calls 1,
    KEPT_EVERY, KEPT_EVERY^2, ... of each kernel entry keep their inputs
    (the entry, unchanged, still counts its launches), and after the run
    each kept call is launched again and held against its plain version at
    TOL.  Writes the counts and the checks to EXAMPLE_LOGS/<name>.json."""
    kept = {entry: [] for _, entry, _ in ENTRIES}
    calls = dict.fromkeys(kept, 0)
    originals = {entry: getattr(mod, entry) for mod, entry, _ in ENTRIES}

    def keeping(entry):
        def call(*args, **kw):
            calls[entry] += 1
            if calls[entry] == KEPT_EVERY ** len(kept[entry]):
                kept[entry].append((tuple(a if a is None else a.clone() for a in args), kw))
            return originals[entry](*args, **kw)
        return call

    for mod, entry, _ in ENTRIES:
        setattr(mod, entry, keeping(entry))
    try:
        reset_launches()
        run()
        launches = read_launches()
    finally:
        for mod, entry, _ in ENTRIES:
            setattr(mod, entry, originals[entry])
    checks = []
    for _, entry, kernel in ENTRIES:
        for args, kw in kept[entry]:
            got, want = originals[entry](*args, **kw), _plain_of(entry, args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            shape = f"B={args[0].shape[0]} N={got.shape[1]} d={args[0].shape[1]} " \
                    f"table={args[1].shape[0]} {args[0].dtype}"
            checks.append(dict(kernel=kernel, entry=entry, shape=shape, max_abs_err=err))
            require(torch.allclose(got, want, **TOL[kernel]),
                    f"examples: {name}: {entry} disagrees with its plain version at {shape}: "
                    f"{err}")
    EXAMPLE_LOGS.mkdir(parents=True, exist_ok=True)
    (EXAMPLE_LOGS / f"{name}.json").write_text(json.dumps(dict(launches=launches,
                                                               checks=checks)))


def _example_rank(rank: int, world: int, port: int, device_type: str, results) -> None:
    """distributed_search_torch's rank (a spawned process), rank 0 observed
    as ``_observed`` observes a twin."""
    import distributed_search_torch as ex

    if rank:
        return ex.rank_main(rank, world, port, device_type, results)
    _observed(lambda: ex.rank_main(rank, world, port, device_type, results),
              "distributed_search_torch")


def run_example(name: str) -> int:
    """``chip_smoke.py --example NAME``: the twin ``examples/NAME.py`` by its
    own main, with no arguments (so on the card), observed: in this
    process, or in distributed_search's rank 0, which the twin spawns."""
    import importlib

    sys.path.insert(0, str(ROOT / "examples"))
    ex = importlib.import_module(name)
    if name == "distributed_search_torch":
        ex.rank_main = _example_rank  # the spawned rank runs the twin's own rank_main
        ex.main([])
    else:
        _observed(lambda: ex.main([]), name)
    return 0


def phase_examples(card: str) -> dict:
    """The twins as subprocesses on the card, started together: each must
    exit 0 and print ``OK`` last, its run must have launched its kernels
    (EXAMPLES), and the calls it kept must agree with the plain versions;
    its recall lines, launches, checks and wall seconds (from its start to
    its exit, beside the other two) are reported."""
    import re

    EXAMPLE_LOGS.mkdir(parents=True, exist_ok=True)
    out, procs, ends = dict(card=card, side_by_side=list(EXAMPLES)), {}, {}
    t0 = time.perf_counter()
    try:
        for name in EXAMPLES:
            (EXAMPLE_LOGS / f"{name}.json").unlink(missing_ok=True)
            with open(EXAMPLE_LOGS / f"{name}.out", "w") as so, \
                    open(EXAMPLE_LOGS / f"{name}.err", "w") as se:
                procs[name] = subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--example", name], cwd=ROOT,
                    stdout=so, stderr=se, text=True)
        while len(ends) < len(procs) and time.perf_counter() - t0 < EXAMPLE_TIMEOUT_S:
            for name, proc in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    launches = dict.fromkeys(KERNELS, 0)
    for name, proc in procs.items():
        lines = (EXAMPLE_LOGS / f"{name}.out").read_text().splitlines()
        require(name in ends and proc.returncode == 0 and lines and lines[-1] == "OK",
                f"examples: {name} exited {proc.returncode} after {ends.get(name)} s: "
                f"{(EXAMPLE_LOGS / f'{name}.err').read_text()[-2000:]}")
        seen = json.loads((EXAMPLE_LOGS / f"{name}.json").read_text())
        out[name] = dict(wall_s=ends[name], exit_code=proc.returncode, lines=lines,
                         recall={m.group(1) or "recall": float(m.group(2)) for m in (
                             re.search(r"(?:^(\w+)\s+)?recall(?:@10)?\s*=\s*([0-9.]+)", ln)
                             for ln in lines) if m}, **seen)
        print(f"examples: {name}:", json.dumps(out[name]), flush=True)
        require(all(seen["launches"][k] > 0 for k in EXAMPLES[name]),
                f"examples: {name} launched {seen['launches']}, not each of {EXAMPLES[name]}")
        require({c["kernel"] for c in seen["checks"]} >= set(EXAMPLES[name]),
                f"examples: {name} kept no call of some of {EXAMPLES[name]}: {seen['checks']}")
        for k, n in seen["launches"].items():
            launches[k] += n
    out["launches"] = launches
    return out


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--example"]:
        return run_example(sys.argv[2])
    dev = torch.device("cuda")
    card = card_line()
    print("card:", card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.sources())} sources, "
          f"loaded: {kernels_built()}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())
    sass = sass_counts(_build.BUILD_DIR / _build.LIB_NAME)
    print("sass: tensor-core instructions per kernel family:", json.dumps(sass))
    require(not sass or (sass["flash_attention_wgmma_kernel"]["HGMMA"] > 0 and
                         sass["paged_attention_mma_kernel"]["HMMA"] > 0 and
                         sass["flash_attention_tf32_kernel"]["TF32"] > 0 and
                         sass["binary_mma_kernel"]["HMMA"] > 0),
            f"the bf16 and fp32 flash, bf16 paged and binary_ip sweep kernels must use the "
            f"tensor cores: {sass}")

    phase_s = {}
    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    phase_s["kernels"] = time.perf_counter() - t0
    attn_rows, attn_launches = phase_attention(dev, card)
    phase_s["attention kernels"] = time.perf_counter() - t0 - sum(phase_s.values())
    tables, qb1m, base1m = phase_tables(np.random.default_rng(0))
    phase_s["tables"] = time.perf_counter() - t0 - sum(phase_s.values())
    search, (ds, graph, qb) = phase_search()
    phase_s["search"] = time.perf_counter() - t0 - sum(phase_s.values())
    plane = phase_serving(ds, graph, qb, card)
    phase_s["serving plane"] = time.perf_counter() - t0 - sum(phase_s.values())
    velo = phase_velo_device(dev, ds, graph, qb, qb1m, base1m, card)
    del qb1m, base1m
    phase_s["velo device"] = time.perf_counter() - t0 - sum(phase_s.values())
    kv = [phase_kv_serve(dev, card, KV_CUT_PAGES, thrash=True),
          phase_kv_serve(dev, card, KV_LAYER_PAGES, thrash=False)]
    phase_s["kv serve"] = time.perf_counter() - t0 - sum(phase_s.values())
    verify = phase_verify(ds, graph, qb, card)
    phase_s["verify"] = time.perf_counter() - t0 - sum(phase_s.values())
    lm = phase_lm_serve(dev, ds, graph, qb, card)
    phase_s["lm serve"] = time.perf_counter() - t0 - sum(phase_s.values())
    train = phase_lm_train(dev, card)
    phase_s["lm train"] = time.perf_counter() - t0 - sum(phase_s.values())
    shard = phase_lm_shard(dev, card, lm, train)
    phase_s["lm shard"] = time.perf_counter() - t0 - sum(phase_s.values())
    examples = phase_examples(card)
    phase_s["examples"] = time.perf_counter() - t0 - sum(phase_s.values())
    print(f"phase seconds on {card}:", json.dumps(phase_s))

    # each phase's launches by kernel, summed over that phase's main runs
    path_launches = {
        "search": {n: sum(r["launches"].get(n, 0) for r in search["torch"]) for n in KERNELS},
        "serving plane": plane["launches"],
        "velo device": velo["launches"],
        "kv serve": {n: sum(r["launches"][n] for r in kv) for n in KERNELS},
        "verify": verify["launches"],
        "attention kernels": attn_launches,
        "lm serve": lm["launches"],
        "lm train": {n: train["launches"][n] + train["adamw8"]["launches"][n]
                     + train["cli"]["launches"][n] for n in KERNELS},
        "lm shard": shard["launches"],
        "examples": examples["launches"],
    }
    report = []
    for name, spec in KERNELS.items():
        mine = [r for r in rows + attn_rows if r["kernel"] == name]
        main = next(r for r in mine if all(r.get(k) == v for k, v in spec["main"].items()))
        report.append(dict(
            name=name, route="cuda", source=spec["source"], replaces=spec["replaces"],
            launches=sum(path_launches[p][name] for p in spec["paths"]),
            max_abs_err=max([r["max_abs_err"] for r in mine]
                            + [c["max_abs_err"] for c in velo["chunk_check"]
                               if name == "binary_ip"]
                            + [c["max_abs_err"] for ex in EXAMPLES for c in examples[ex]["checks"]
                               if c["kernel"] == name]
                            + ([lm["flash_checked"]["max_abs_err"],
                                train["flash_checked"]["max_abs_err"],
                                train["adamw8"]["flash_checked"]["max_abs_err"]]
                               if name == "flash_attention" else [])),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
        ))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, kernels=report, launches_by_phase=path_launches, shapes=rows,
             attention=attn_rows, tables=tables, search=search, serving_plane=plane,
             velo_device=velo, kv_serve=kv, verify=verify, lm_serve=lm, lm_train=train,
             lm_shard=shard, examples=examples, phase_s=phase_s,
             sass=sass),
        indent=1, default=float))
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
