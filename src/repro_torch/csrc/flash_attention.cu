// flash_attention: prefill attention with causal and sliding-window masks
// and grouped KV heads.  out[b, h, i] = softmax(q[b, h, i] . K^T * scale) V
// over the keys j of KV head h / (H / KVH) that row i may see: j < Skv;
// with causal, j <= i + (Skv - Sq) (queries right-aligned to keys); with a
// window, j > i + (Skv - Sq) - window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, driven by flash_attention_pallas), whose grid
// (B, H, Sq/BQ, Skv/BK) carries the online-softmax state across the
// sequential key axis in VMEM, after ops.py pads both lengths to tiles.
//
// What bounds it on the H100.  Operations: 4 * Dh flops per (query, visible
// key) pair, e.g. 34.4 GFLOP for Yi-6B's causal prefill at S = 2048 against
// a few MB of q, k, v and out, far above both ridges (20 flops a byte in
// fp32, 295 in bf16).  The bound is the tensor-core peak for bf16 inputs
// (35 us there) and the TF32 peak (495 TFLOP/s, useful products only) for
// fp32 inputs, which now run on the tensor cores; chip_smoke.py also gives
// the fp32 CUDA-core peak's bound (67 TFLOP/s) for continuity.
//
// bf16 inputs: tensor cores, fed by TMA.  One block per (128-row query
// tile, head, sequence), heaviest tiles first under causal masking: a
// producer warp keeps K and V tiles of BK keys (128; 64 at Dh = 256) in a
// ring of 2-3 stages of shared memory, loaded by TMA (cp.async.bulk.tensor,
// swizzled, zero-filled past Sq and Skv) and completing on mbarriers (rows
// are cut into atoms of at most 64 dims, and the swizzle span is an atom's
// row: 128 B, 64 B at Dh 32, 32 B at Dh 16, where Q K^T is one k-step and
// P V an N = 16 product); two
// consumer warpgroups of 64 query rows each, holding the registers that
// setmaxnreg takes from the producer, compute S = Q K^T with wgmma from
// shared memory, the online softmax in fp32 registers in wgmma's
// accumulator layout (a row lives in the 4 lanes of a quad: two shuffles
// for its max, its sum kept per lane until the end), and O += P V with
// wgmma, P from registers and V read MN-major from shared memory.  Each
// step issues S of one key tile with P V of the one before as one group,
// and the two warpgroups take turns to issue (named barriers), so that one
// runs its softmax while the tensor cores work for the other.  P is
// split into hi = bf16(p) and lo = bf16(p - hi), each multiplied with V into
// the same fp32 O: a single bf16 P errs by up to 2^-9 of each p * v term,
// more than one bf16 ulp of the output where terms cancel, and the kernel is
// held to one ulp of its plain version.  That costs 6 * Dh flops a pair
// instead of 4 * Dh.  Key tiles that the masks rule out for the whole query
// tile are never loaded; masks are evaluated only on tiles that cross the
// causal diagonal, the window edge or Skv.  A masked key gets probability 0
// (exp2(-inf - m) with a finite m that starts at -1e30), so a row that sees
// no key gives 0 / max(0, 1e-30) = 0.
//
// fp32 inputs: 3xTF32 on the tensor cores.  One TF32 pass (10 mantissa
// bits) errs by up to 2^-11 of each product, 9-77x over the fp32 bar
// (rtol 1e-4, atol 1e-5) at Yi-6B, whisper-small and Dh 256 widths; with
// every operand split into hi = tf32(x) and lo = tf32(x - hi) and each
// product taken as lo.hi + hi.lo + hi.hi in fp32 accumulators, the error
// falls to ~1e-6, 1-5 % of the bar (tests/test_torch_attention.py emulates
// both).  That is 3x the useful products, still far above the CUDA cores'
// rate.  The instruction is mma.sync m16n8k8 tf32: TF32 wgmma would want V
// K-major in shared memory (a transpose on the way in), and the split has
// to happen in registers anyway.
//
// One block per (64-row query tile, head, sequence), four warps of 16
// query rows; under causal masking the heavy half of the tiles is launched
// first and the light half after it, so that the two blocks an SM holds
// carry about equal work.  Q and a two-stage ring of K/V tiles (64 keys;
// 32 at Dh >= 128, so that two blocks fit an SM at Dh 128 and two stages
// fit at Dh 256) come in by cp.async, the copy of tile i + 1 overlapping
// the products of tile i, rows past Sq and Skv zero-filled.  Operands are
// split on the fly as fragments are read, in integer operations (sm_90
// has no single instruction for cvt.rna.tf32: the compiler emits a
// sequence of compares, adds and selects); Q stays in shared memory (at Dh 256 a warp's O
// alone is 128 registers a thread).  The three products of a fragment are
// issued term by term across the fragments of a step (S keeps hi.hi and
// the two lo terms in separate accumulators), since an mma.sync into an
// accumulator waits out the latency of the one before it.
//
// Layouts.  In S's k-steps fragment column t is dim 2t and column t + 4 is
// dim 2t + 1, so a lane reads its two dims of Q and of K as one float2.
// The S accumulator gives lane (g, t) keys 2t and 2t + 1 of each 8-key
// slice; P's A fragment takes column t as key 2t and t + 4 as key 2t + 1,
// and V's B fragment is read in that key order, so P never leaves the
// registers.  Q and K rows are padded by 8 floats, V rows (read as single
// words, four keys at once) by 4, so that every fragment read hits
// distinct banks.  The online softmax and the masks are the bf16 kernel's.
//
// Shared memory above 48 KB (56-225 KB bf16, 46-200 KB fp32): the launch
// raises the dynamic limit first and returns the error if the card refuses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int H, KVH, Sq, Skv, causal, has_window, window;
  float scale;
};

// The keys [k_lo, k_hi) that some real row of query tile [q0, q0 + bq) may see.
__device__ __forceinline__ void key_range(const Shape& s, int q0, int bq, int& k_lo, int& k_hi) {
  const int offset = s.Skv - s.Sq;  // key position of query row 0
  const int last_row = min(q0 + bq, s.Sq) - 1;
  k_lo = 0;
  k_hi = s.Skv;
  if (s.causal) k_hi = min(k_hi, last_row + offset + 1);
  if (s.has_window) k_lo = max(k_lo, q0 + offset - s.window + 1);
}

// ------------------------------------------------------------ bf16: wgmma + TMA

template <int DH>
struct Tile {
  static constexpr int BQ = 128;                         // query rows per block
  static constexpr int BK = DH == 256 ? 64 : 128;        // keys per tile
  static constexpr int STAGES = DH == 256 ? 2 : 3;       // K/V ring
  static constexpr int DA = DH < 64 ? DH : 64;          // columns per swizzle atom
  static constexpr int ROWB = DA * 2;                    // bytes of an atom's row
  // descriptor mode, the swizzle span being the atom's row: 32 B / 64 B / 128 B
  static constexpr uint32_t SWZ = DH == 16 ? 3 : DH == 32 ? 2 : 1;
  static constexpr int NATOM = DH / DA;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES;  // + barriers, + alignment
  static constexpr int THREADS = 384;                    // producer + 2 consumer warpgroups
};

template <int DH>
__global__ void __launch_bounds__(384, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, Shape s,
    int n_qtiles) {
  using C = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment; each tile is [atom][row][DA]
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = base;
  uint8_t* ks = qs + C::Q_BYTES;
  uint8_t* vs = ks + C::STAGES * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + C::STAGES * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* empty = v_full + C::STAGES;

  const int tile = s.causal ? n_qtiles - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int q0 = tile * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (s.H / s.KVH);
  int k_lo, k_hi;
  key_range(s, q0, C::BQ, k_lo, k_hi);
  const int kt0 = k_lo / C::BK;
  const int n_tiles = k_lo < k_hi ? (k_hi + C::BK - 1) / C::BK - kt0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(empty + i, 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: one thread issues every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < C::NATOM; ++j)
        tma_load_3d(qs + j * C::BQ * C::ROWB, &tq, q_full, j * C::DA, q0, b * s.H + h);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(empty + st, (i / C::STAGES - 1) & 1);
        const int k0 = (kt0 + i) * C::BK, row = b * s.KVH + kvh;
        mbar_expect_tx(k_full + st, C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::NATOM; ++j)
          tma_load_3d(ks + st * C::KV_BYTES + j * C::BK * C::ROWB, &tk, k_full + st, j * C::DA,
                      k0, row);
        mbar_expect_tx(v_full + st, C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::NATOM; ++j)
          tma_load_3d(vs + st * C::KV_BYTES + j * C::BK * C::ROWB, &tv, v_full + st, j * C::DA,
                      k0, row);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int offset = s.Skv - s.Sq;
  const int row0 = q0 + 64 * cw + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int wg_first = q0 + 64 * cw, wg_last = wg_first + 63;
  const float scale2 = s.scale * kLog2e;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  // Step i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} as one group, then
  // runs the softmax of S_i.  The two warpgroups take turns to issue (named
  // barriers 1 and 2), so that one's softmax overlaps the other's products.
  float sc[C::BK / 2];
  uint32_t ph[C::BK / 4], pl[C::BK / 4];  // P_{i-1}: bf16 pairs, A fragments of PV
  if (n_tiles > 0) mbar_wait(q_full, 0);
  if (cw == 1) named_bar_arrive(1, 256);  // warpgroup 0 issues first
  for (int i = 0; i <= n_tiles; ++i) {
    const bool has_s = i < n_tiles, has_pv = i > 0;
    const int st = i % C::STAGES, pst = (i + C::STAGES - 1) % C::STAGES;
    if (has_s) mbar_wait(k_full + st, (i / C::STAGES) & 1);
    if (has_pv) mbar_wait(v_full + pst, ((i - 1) / C::STAGES) & 1);
    named_bar_sync(1 + cw, 256);
    reg_fence(o);
    reg_fence(ph);
    reg_fence(pl);
    wgmma_fence();
    if (has_s) {
      const uint8_t* kt = ks + st * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int j = kk * 16 / C::DA, off = (kk * 16 % C::DA) * 2;
        const uint64_t da = wgmma_desc(qs + j * C::BQ * C::ROWB + cw * 64 * C::ROWB + off, 16,
                                       8 * C::ROWB, C::SWZ);
        const uint64_t db = wgmma_desc(kt + j * C::BK * C::ROWB + off, 16, 8 * C::ROWB, C::SWZ);
        Wgmma<C::BK>::ss(sc, da, db, kk > 0);
      }
    }
    if (has_pv) {  // the A fragment of keys 16kk.. is ph[4kk .. 4kk + 3]
      const uint8_t* vt = vs + pst * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        const uint64_t db =
            wgmma_desc(vt + kk * 16 * C::ROWB, C::BK * C::ROWB, 8 * C::ROWB, C::SWZ);
        const uint32_t a_hi[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
        const uint32_t a_lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
        Wgmma<DH>::rs(o, a_hi, db);
        Wgmma<DH>::rs(o, a_lo, db);
      }
    }
    wgmma_commit();
    named_bar_arrive(2 - cw, 256);
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(o);
    if (has_pv && lane == 0) mbar_arrive(empty + pst);  // K and V of step i - 1 are read
    if (!has_s) continue;

    // online softmax of S_i in the log2 domain (p = 2^(s scale log2(e) - m));
    // sc[4j + 2r + c] is row row0 + 8r, key k0 + 8j + 2 quad + c
    const int k0 = (kt0 + i) * C::BK;
    const bool need_mask = k0 + C::BK > s.Skv ||
                           (s.causal && k0 + C::BK - 1 > wg_first + offset) ||
                           (s.has_window && k0 <= wg_last + offset - s.window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[4 * j + 2 * r + c];
          if (need_mask) {
            const int kp = k0 + 8 * j + 2 * quad + c;
            const bool ok = kp < s.Skv && (!s.causal || kp <= qp) &&
                            (!s.has_window || kp > qp - s.window);
            x = ok ? x : -INFINITY;
            sc[4 * j + 2 * r + c] = x;
          }
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // the scale is positive, so the max of scaled scores is the scaled max
      const float m_new = fmaxf(m_r[r], mx * scale2);
      const float alpha = fast_exp2(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) {
        const float p0 = fast_exp2(fmaf(sc[4 * j + 2 * r], scale2, -m_new));
        const float p1 = fast_exp2(fmaf(sc[4 * j + 2 * r + 1], scale2, -m_new));
        sum += p0 + p1;
        split_bf16(p0, p1, ph[2 * j + r], pl[2 * j + r]);
      }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 2 * r] *= alpha;
        o[4 * j + 2 * r + 1] *= alpha;
      }
    }
  }
  if (cw == 0) named_bar_sync(1, 256);  // warpgroup 1's last turn

  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * s.H + h) * s.Sq * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < s.Sq) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(row) * DH + 8 * j +
                                           2 * quad) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (heads, rows, DH) bf16 tensor as boxes of (1, box_rows, DA), swizzled
// as the wgmma descriptors read them; rows past `rows` read as zeros.
template <int DH>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int heads, int box_rows) {
  using C = Tile<DH>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {DH, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {DH * 2, static_cast<cuuint64_t>(rows) * DH * 2};
  const cuuint32_t box[3] = {C::DA, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::SWZ == 1   ? CU_TENSOR_MAP_SWIZZLE_128B
                : C::SWZ == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                        const Shape& s, cudaStream_t stream) {
  using C = Tile<DH>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<DH>(&tq, q, s.Sq, B * s.H, C::BQ) ||
      !tensor_map<DH>(&tk, k, s.Skv, B * s.KVH, C::BK) ||
      !tensor_map<DH>(&tv, v, s.Skv, B * s.KVH, C::BK))
    return cudaErrorInvalidValue;
  const int smem = C::SMEM + (1 + 3 * C::STAGES) * 8 + 1024;
  auto kernel = flash_attention_wgmma_kernel<DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (s.Sq + C::BQ - 1) / C::BQ;
  const dim3 grid(n_qtiles, s.H, B);
  kernel<<<grid, C::THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), s,
                                             n_qtiles);
  return cudaGetLastError();
}

// ------------------------------------------------------------ fp32: 3xTF32 mma.sync

template <int DH>
struct F32Tile {
  static constexpr int BQ = 64;                 // query rows per block, 16 per warp
  static constexpr int BK = DH >= 128 ? 32 : 64;  // keys per tile
  static constexpr int STAGES = 2;              // K/V ring
  // padded row strides (floats): Q and K are read as float2 pairs (8 banks
  // a row apart), V as single words (4 banks a row apart)
  static constexpr int LDK = DH + 8;
  static constexpr int LDV = DH + 4;
  static constexpr int THREADS = 128;
  static constexpr int K_FLOATS = BK * LDK;
  static constexpr int V_FLOATS = BK * LDV;
  static constexpr int SMEM = (BQ * LDK + STAGES * (K_FLOATS + V_FLOATS)) * 4;
};

// rows [r0, r0 + n) of a (rows, DH) fp32 matrix into shared memory with row
// stride LD by cp.async, 16 bytes a thread at a time; rows at or past
// `rows` are zero-filled
template <int DH, int LD>
__device__ __forceinline__ void load_rows_async(const float* __restrict__ src, float* dst, int r0,
                                                int n, int rows) {
  constexpr int PER_ROW = DH / 4;
  for (int idx = threadIdx.x; idx < n * PER_ROW; idx += F32Tile<DH>::THREADS) {
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * 4;
    const bool ok = r0 + r < rows;
    cp_async16_zfill(dst + r * LD + c, src + (ok ? static_cast<int64_t>(r0 + r) * DH + c : 0),
                     ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(128) flash_attention_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, Shape s, int n_qtiles) {
  using C = F32Tile<DH>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (BQ, LDK)
  float* ks = qs + C::BQ * C::LDK;              // STAGES x (BK, LDK)
  float* vs = ks + C::STAGES * C::K_FLOATS;     // STAGES x (BK, LDV)

  // Under causal masking a query tile's work grows with its index.  Blocks
  // start in launch order and two share an SM, so the first half of the
  // launch takes the heavy half of the tiles, heaviest first, and the
  // second half the light half, lightest first: the block that joins a
  // heavy one on its SM is a light one.
  const int L = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int HB = gridDim.y * gridDim.z, rank = L / HB, hb = L % HB;
  const int half = (n_qtiles + 1) / 2;
  const int tile = !s.causal ? rank : rank < half ? n_qtiles - 1 - rank : rank - half;
  const int q0 = tile * C::BQ, h = hb % gridDim.y, b = hb / gridDim.y;
  const int kvh = h / (s.H / s.KVH);
  const float* qb = q + (static_cast<int64_t>(b) * s.H + h) * s.Sq * DH;
  const float* kb = k + (static_cast<int64_t>(b) * s.KVH + kvh) * s.Skv * DH;
  const float* vb = v + (static_cast<int64_t>(b) * s.KVH + kvh) * s.Skv * DH;
  int k_lo, k_hi;
  key_range(s, q0, C::BQ, k_lo, k_hi);
  const int kt0 = k_lo / C::BK;
  const int n_tiles = k_lo < k_hi ? (k_hi + C::BK - 1) / C::BK - kt0 : 0;

  if (n_tiles > 0) {  // group 0: Q and the first K/V tile
    load_rows_async<DH, C::LDK>(qb, qs, q0, C::BQ, s.Sq);
    load_rows_async<DH, C::LDK>(kb, ks, kt0 * C::BK, C::BK, s.Skv);
    load_rows_async<DH, C::LDV>(vb, vs, kt0 * C::BK, C::BK, s.Skv);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int offset = s.Skv - s.Sq;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const int w_first = q0 + 16 * warp, w_last = w_first + 15;
  const float scale2 = s.scale * kLog2e;
  const float* qw = qs + (16 * warp + g) * C::LDK + 2 * t;  // A fragments of this warp's rows

  float o[DH / 2];  // o[4n + 2r + c]: row row0 + 8r, dim 8n + 2t + c
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {  // the next tile into the other stage, behind this one
      const int st = (i + 1) % C::STAGES, k1 = (kt0 + i + 1) * C::BK;
      load_rows_async<DH, C::LDK>(kb, ks + st * C::K_FLOATS, k1, C::BK, s.Skv);
      load_rows_async<DH, C::LDV>(vb, vs + st * C::V_FLOATS, k1, C::BK, s.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + (i % C::STAGES) * C::K_FLOATS;
    const float* vt = vs + (i % C::STAGES) * C::V_FLOATS;

    // S = Q K^T: sc[4j + 2r + c] is row row0 + 8r, key k0 + 8j + 2t + c.
    // The order of the 8 dims of a k-step is free as long as A and B agree:
    // fragment column t is dim 2t and t + 4 is dim 2t + 1, so each lane
    // reads its two dims of Q and of K as one float2
    // 3xTF32 as hi.hi into sc and lo.hi + hi.lo into sc2, issued term by
    // term over the key slices, so that no product waits on the one before
    float sc[C::BK / 2], sc2[C::BK / 2];
#pragma unroll
    for (int j = 0; j < C::BK / 2; ++j) sc[j] = sc2[j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DH / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qw + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qw + 8 * C::LDK + 8 * kk);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
      uint32_t bh[C::BK / 8][2], bl[C::BK / 8][2];
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) {  // B[dim][key g] = K[8j + g][8kk + 2t (+1)]
        const float2 kv =
            *reinterpret_cast<const float2*>(kt + (8 * j + g) * C::LDK + 8 * kk + 2 * t);
        split_tf32(kv.x, bh[j][0], bl[j][0]);
        split_tf32(kv.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) mma_tf32_1688(sc2 + 4 * j, al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) mma_tf32_1688(sc + 4 * j, ah, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) mma_tf32_1688(sc2 + 4 * j, ah, bl[j][0], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < C::BK / 2; ++j) sc[j] += sc2[j];

    // online softmax in the log2 domain, as in the bf16 kernel
    const int k0 = (kt0 + i) * C::BK;
    const bool need_mask = k0 + C::BK > s.Skv ||
                           (s.causal && k0 + C::BK - 1 > w_first + offset) ||
                           (s.has_window && k0 <= w_last + offset - s.window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[4 * j + 2 * r + c];
          if (need_mask) {
            const int kp = k0 + 8 * j + 2 * t + c;
            const bool ok = kp < s.Skv && (!s.causal || kp <= qp) &&
                            (!s.has_window || kp > qp - s.window);
            x = ok ? x : -INFINITY;
          }
          sc[4 * j + 2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx * scale2);
      const float alpha = fast_exp2(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = fast_exp2(fmaf(sc[4 * j + 2 * r + c], scale2, -m_new));
          sc[4 * j + 2 * r + c] = p;
          sum += p;
        }
      }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n + 2 * r] *= alpha;
        o[4 * n + 2 * r + 1] *= alpha;
      }
    }

    // O += P V.  The A fragment of keys 8j.. takes column t as key 2t and
    // column t + 4 as key 2t + 1, so it is this thread's own S accumulator
    // (no shuffle); V's B fragment is read in the same key order
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(sc[4 * j], ah[0], al[0]);
      split_tf32(sc[4 * j + 2], ah[1], al[1]);
      split_tf32(sc[4 * j + 1], ah[2], al[2]);
      split_tf32(sc[4 * j + 3], ah[3], al[3]);
      const float* vr = vt + (8 * j + 2 * t) * C::LDV + g;
      constexpr int NS = DH / 8 < 4 ? DH / 8 : 4;  // dim slices a round (two at Dh 16)
#pragma unroll
      for (int n0 = 0; n0 < DH / 8; n0 += NS) {  // NS dim slices, term by term
        uint32_t bh[NS][2], bl[NS][2];
#pragma unroll
        for (int n = 0; n < NS; ++n) {  // B[key][dim g] = V[8j + 2t (+1)][8(n0 + n) + g]
          split_tf32(vr[8 * (n0 + n)], bh[n][0], bl[n][0]);
          split_tf32(vr[C::LDV + 8 * (n0 + n)], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) mma_tf32_1688(o + 4 * (n0 + n), al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < NS; ++n) mma_tf32_1688(o + 4 * (n0 + n), ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < NS; ++n) mma_tf32_1688(o + 4 * (n0 + n), ah, bh[n][0], bh[n][1]);
      }
    }
    __syncthreads();  // this stage is read: the next iteration's copy may overwrite it
  }
  cp_async_wait<0>();

  float* ob = out + (static_cast<int64_t>(b) * s.H + h) * s.Sq * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < s.Sq) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<float2*>(ob + static_cast<int64_t>(row) * DH + 8 * n + 2 * t) =
            make_float2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B,
                       const Shape& s, cudaStream_t stream) {
  using C = F32Tile<DH>;
  auto kernel = flash_attention_tf32_kernel<DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (s.Sq + C::BQ - 1) / C::BQ;
  const dim3 grid(n_qtiles, s.H, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(static_cast<const float*>(q),
                                                static_cast<const float*>(k),
                                                static_cast<const float*>(v),
                                                static_cast<float*>(out), s, n_qtiles);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, int, const Shape&,
                               cudaStream_t);

int entry(const Launch (&by_dh)[5], const void* q, const void* k, const void* v, void* out, int B,
          int H, int KVH, int Sq, int Skv, int Dh, int causal, int has_window, int window,
          float scale, int device, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 || B > 65535 ||
      H > 65535 || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int which =
      Dh == 16 ? 0 : Dh == 32 ? 1 : Dh == 64 ? 2 : Dh == 128 ? 3 : Dh == 256 ? 4 : -1;
  if (which < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s{H, KVH, Sq, Skv, causal, has_window, window, scale};
  err = by_dh[which](q, k, v, out, B, s, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

constexpr Launch kF32[5] = {launch_f32<16>, launch_f32<32>, launch_f32<64>, launch_f32<128>,
                            launch_f32<256>};
constexpr Launch kBf16[5] = {launch_bf16<16>, launch_bf16<32>, launch_bf16<64>,
                             launch_bf16<128>, launch_bf16<256>};

}  // namespace

// Plain C entries for ctypes.  q and out are (B, H, Sq, Dh), k and v
// (B, KVH, Skv, Dh), all row-major in one dtype (fp32 or bf16), 16-byte
// aligned; Dh is 16, 32, 64, 128 or 256 and H a multiple of KVH.  causal and
// has_window are 0 or 1; window is used only when has_window is 1.
// Returns the launch's cudaError_t; 0 is success.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int H, int KVH, int Sq, int Skv, int Dh, int causal,
                                   int has_window, int window, float scale, int device,
                                   void* stream) {
  return entry(kF32, q, k, v, out, B, H, KVH, Sq, Skv, Dh, causal, has_window, window, scale,
               device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int KVH, int Sq, int Skv, int Dh, int causal,
                                    int has_window, int window, float scale, int device,
                                    void* stream) {
  return entry(kBf16, q, k, v, out, B, H, KVH, Sq, Skv, Dh, causal, has_window, window, scale,
               device, stream);
}
