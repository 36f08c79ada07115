// binary_ip: the sign product under RaBitQ's level-1 distance estimate,
//   out[b, n] = <q_b, 2 * bit(codes[row_n]) - 1>,
// and the estimate itself in the same launch,
//   est[b, n] = qn^2 + x^2 - 2 qn x clip(g / sqrt(d) / max(ip_bar, 1e-6), -1, 1)
// with qn = ||q_b||, g = <q_b / max(qn, 1e-12), s_n>, x = norms[row_n].
//
// Replaces the Pallas TPU kernel src/repro/kernels/binary_ip/kernel.py
// (_binary_ip_kernel, driven by binary_ip_pallas), which unpacks the codes in
// VMEM and feeds the 128x128 MXU, and the XLA epilogue around it in
// repro/kernels/binary_ip/ops.py::estimate_dist2 (query norms, the gathers of
// norms and ip_bar, the clip), which XLA fuses around the Pallas call.  Here
// the whole estimate is one launch.
//
// What bounds it on the H100.  On the search path (B <= 8 queries, N ~ 64-256
// rows gathered by id from a resident table, d = 128) a call moves ~20 KB:
// the launch and two dependent global loads (the id, then the code row) are
// its critical path, and whatever runs before them or serialises after them
// adds to it.  A full sweep of a 1M-row table at B = 8 moves 16 MB of codes
// and writes 32 MB of (B, N) fp32 output: 14.3 us at 3.35 TB/s.  On the CUDA
// cores its 2 B N d products (one FMA each, the query value from shared
// memory) take ~30 us at the fp32 peak; on the tensor cores the products
// are cheap, and what paces a sweep is instruction issue: turning code bits
// into bf16 operands (two integer instructions a register of two signs, 256
// a 64-row tile beside 96 mma), the loads' address arithmetic and the
// epilogue.
//
// Design, two paths.  The wrapper (kernels/binary_ip/kernel.py,
// tensor_core_path) picks the tensor cores for calls of two queries or more
// over 8 192 rows or more, where d % 32 == 0; the lanes path otherwise.
// * Lanes (the search path's flushes, and any d): the int4_dist design.  A
//   code row of d/8 bytes is cut into chunks of CB bytes (the widest of 4,
//   2, 1 that the row, the table's alignment and at least 8 chunks allow: 8
//   lanes of 2 bytes at d = 128, 30 chunks of 4 bytes over 32 lanes at
//   d = 960); the LPR lanes of a row take chunks j, j + LPR, ...  Blocks of
//   64 threads spread N = 256 over 32 SMs.  Each lane first reads the id,
//   then its chunk, norms[id] and ip_bar[id]; only then is Q staged in
//   shared memory with 16-byte loads (rows padded by 4 floats a chunk so
//   that the lanes of a row read distinct banks), and ||q_b||^2 is reduced
//   from the staged values behind the one barrier; lane b of each warp
//   takes query b's square root and division, and shuffles share them.  The
//   product is taken on the raw q and scaled once by 1 / (max(||q||, 1e-12)
//   sqrt(d)) and by 1 / max(ip_bar, 1e-6), one reciprocal a row: the
//   estimate needs no division a (b, n).  Lane partials meet by
//   __shfl_xor_sync; the estimate is computed in registers and lane j
//   writes queries j, j + LPR, ...  For large N (d % 32 != 0, or B = 1) the
//   grid is capped and one lane takes a row, as in int4_dist.
// * Tensor cores (sweeps): mma.sync.m16n8k16, bf16 in, fp32 accumulators.
//   A = 16 code rows x 16 dims of +-1, exact in bf16; B = 16 dims x 8
//   queries.  fp32 queries are split as q = q1 + q2 + q3 with q1 = bf16(q),
//   q2 = bf16(q - q1), q3 = bf16(q - q1 - q2), exact for |q| from 2^-110 to
//   bf16's largest finite value, so every product is exact and only the
//   order of the fp32 sums differs from the plain version; bf16 queries are
//   one term.  q1's products go to one accumulator and q2's and q3's to
//   another, and both restart every 128 dims (fp32 sums carry the total),
//   so that the tensor core's own rounding inside an instruction acts on
//   small partial sums.  The dims are permuted so that the unpack is cheap:
//   lane (g, t) reads 4-byte word t of rows g and g + 8 (one 16-byte row per
//   4 lanes at d = 128, fully coalesced), and in k-step s its A registers
//   pair bits (2s, 2s + 16) and (2s + 1, 2s + 17) of the word (sign_pair);
//   Q's B fragments are laid out in the same order once per block in shared
//   memory (the inner product does not care which dims pair with which k
//   slot as long as q and the signs are permuted alike).  A warp takes 64
//   rows at a time (its first tile's loads issued before the block stages
//   Q; a tile's loads clamped, so unbranched), computes the estimate in
//   registers (each row's
//   norms and ip_bar loaded by one of its four lanes and shuffled to the
//   others) and writes its (8, 64) outputs through shared memory as 256-byte
//   runs a query.  A sweep without ids is its own instantiation, with no id
//   and no range check a row.
// An id outside the table reads nothing and gives NaN from both paths and
// both entries; the clip and the clamps are written as comparisons so that
// NaN passes through them (fminf / fmaxf would drop it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

// RaBitQ's estimator for one (query, row): ip = <q, s> on the raw query,
// qn = ||q||, sc = 1 / (max(qn, 1e-12) sqrt(d)), x = norms[row], rib =
// 1 / max(ip_bar[row], 1e-6).  Multiplications only, so no input takes
// the division's slow path; NaN in any input gives NaN.
__device__ __forceinline__ float estimate(float ip, float qn, float sc, float x, float rib) {
  float c = ip * sc * rib;
  c = c < -1.f ? -1.f : (c > 1.f ? 1.f : c);
  return qn * qn + x * x - 2.f * qn * x * c;
}

__device__ __forceinline__ float inv_ip_bar(float ib) { return 1.f / (ib < 1e-6f ? 1e-6f : ib); }

__device__ __forceinline__ float est_scale(float qn, int d) {
  return 1.f / ((qn < 1e-12f ? 1e-12f : qn) * sqrtf(static_cast<float>(d)));
}

// four consecutive query values as floats; vec: the address is aligned for
// one wide load
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

template <int N>
__device__ __forceinline__ void lane_sum(float (&v)[N], int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// ------------------------------------------------------------ lanes path

constexpr int kThreads = 64;      // threads per block
constexpr int kBlocksPerSm = 16;  // grid cap for large N, in blocks an SM

template <int CB>
__device__ __forceinline__ uint32_t load_chunk(const uint8_t* p) {
  if constexpr (CB == 4) return *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (CB == 2) return *reinterpret_cast<const uint16_t*>(p);
  else return *p;
}

// What a lane needs of one code row: read before anything else is done.
struct RowLoad {
  uint32_t w;    // this lane's first chunk
  float x, ib;   // norms[id], ip_bar[id] (the estimate entry)
  bool ok;       // the row exists and its id is inside the table
};

template <int CB, bool EST>
__device__ __forceinline__ RowLoad fetch_row(int row, int N, const int64_t* __restrict__ ids,
                                             const uint8_t* __restrict__ codes,
                                             const float* __restrict__ norms,
                                             const float* __restrict__ ip_bar, int64_t n_table,
                                             int row_bytes, int j, int chunks) {
  RowLoad r;
  const int64_t src = row < N ? (ids ? ids[row] : row) : -1;
  r.ok = src >= 0 && src < n_table;
  r.w = 0u;
  r.x = r.ib = 0.f;
  if (r.ok) {
    if (j < chunks) r.w = load_chunk<CB>(codes + src * row_bytes + j * CB);
    if constexpr (EST) {
      r.x = norms[src];
      r.ib = ip_bar[src];
    }
  }
  return r;
}

// Bit i of byte k is dimension 8k + i (np.packbits, bitorder="little"), so
// bit i of a little-endian chunk is dimension i past the chunk's first.  qc
// points at the chunk's first dimension of query 0; qs is Q's row stride.
template <int BQ, int CB>
__device__ __forceinline__ void accumulate(uint32_t w, const float* qc, int qs, float (&ip)[BQ]) {
#pragma unroll
  for (int i = 0; i < 8 * CB; i += 4) {
    const float s0 = (w >> i) & 1u ? 1.f : -1.f, s1 = (w >> (i + 1)) & 1u ? 1.f : -1.f;
    const float s2 = (w >> (i + 2)) & 1u ? 1.f : -1.f, s3 = (w >> (i + 3)) & 1u ? 1.f : -1.f;
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      const float4 qv = *reinterpret_cast<const float4*>(qc + b * qs + i);
      ip[b] = fmaf(qv.w, s3, fmaf(qv.z, s2, fmaf(qv.y, s1, fmaf(qv.x, s0, ip[b]))));
    }
  }
}

template <int BQ, int CB, bool EST, typename QT>
__global__ void __launch_bounds__(kThreads) binary_lanes_kernel(
    const QT* __restrict__ q, const uint8_t* __restrict__ codes,
    const int64_t* __restrict__ ids, const float* __restrict__ norms,
    const float* __restrict__ ip_bar, float* __restrict__ out, int B, int N, int d,
    int64_t n_table, int lpr_log2) {
  constexpr int CD = 8 * CB;  // dimensions a chunk
  extern __shared__ float4 smem4[];
  const int chunks = d / CD, row_bytes = d / 8;
  const int QS = d + 4 * chunks;
  float* qsm = reinterpret_cast<float*>(smem4);  // (BQ, QS), 4 pad floats a chunk
  float* red = qsm + BQ * QS;                    // (warps, BQ) partial ||q_b||^2
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x % 32, j = lane & (lpr - 1);
  // rows advance a warp at a time, so every lane of a warp runs every
  // iteration and the shuffles see the whole warp
  const int rows_per_warp = 32 >> lpr_log2;
  const int stride = gridDim.x * (kThreads >> lpr_log2);
  const int base0 = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * rows_per_warp;
  const int in_warp = lane >> lpr_log2;
  const int b0 = blockIdx.y * BQ;

  RowLoad cur = fetch_row<CB, EST>(base0 + in_warp, N, ids, codes, norms, ip_bar, n_table,
                                   row_bytes, j, chunks);

  // stage Q (wide loads, all of a thread's issued before any store) and
  // take ||q_b||^2 of what this thread staged
  float qp[BQ];
#pragma unroll
  for (int b = 0; b < BQ; ++b) qp[b] = 0.f;
  const bool vec = reinterpret_cast<uintptr_t>(q) % (4 * sizeof(QT)) == 0;
  for (int k0 = 0; k0 < d; k0 += 4 * kThreads) {
    const int k = k0 + 4 * threadIdx.x;
    float4 v[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < d && b0 + b < B) v[b] = load4(q + static_cast<int64_t>(b0 + b) * d + k, vec);
    }
    if (k < d) {
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        *reinterpret_cast<float4*>(qsm + b * QS + k + 4 * (k / CD)) = v[b];
        qp[b] = fmaf(v[b].x, v[b].x, fmaf(v[b].y, v[b].y, fmaf(v[b].z, v[b].z,
                fmaf(v[b].w, v[b].w, qp[b]))));
      }
    }
  }
  if constexpr (EST) {
    lane_sum(qp, 32);
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < BQ; ++b) red[(threadIdx.x / 32) * BQ + b] = qp[b];
    }
  }
  __syncthreads();
  // ||q_b|| and the product's scale (the estimate entry): lane b of each
  // warp takes query b's square root and division, and shuffles share them
  float qn[BQ], sc[BQ];
  if constexpr (EST) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += lane < BQ ? red[w * BQ + lane] : 0.f;
    const float my_qn = sqrtf(s), my_sc = est_scale(my_qn, d);
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      qn[b] = __shfl_sync(0xffffffffu, my_qn, b);
      sc[b] = __shfl_sync(0xffffffffu, my_sc, b);
    }
  }

  for (int base = base0; base < N; base += stride) {
    const int row = base + in_warp;
    const RowLoad nxt = fetch_row<CB, EST>(base + stride + in_warp, N, ids, codes, norms,
                                           ip_bar, n_table, row_bytes, j, chunks);
    float acc[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[b] = 0.f;
    if (cur.ok) {
      if (j < chunks) accumulate<BQ, CB>(cur.w, qsm + j * (CD + 4), QS, acc);
      const int64_t src = ids ? ids[row] : row;  // in L1: read by fetch_row
      for (int c = j + lpr; c < chunks; c += lpr)
        accumulate<BQ, CB>(load_chunk<CB>(codes + src * row_bytes + c * CB),
                           qsm + c * (CD + 4), QS, acc);
    }
    lane_sum(acc, lpr);
    if (row < N) {
      const float rib = EST ? inv_ip_bar(cur.ib) : 0.f;
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        if ((b & (lpr - 1)) == j && b0 + b < B) {
          float v = acc[b];
          if constexpr (EST) v = estimate(v, qn[b], sc[b], cur.x, rib);
          out[static_cast<int64_t>(b0 + b) * N + row] = cur.ok ? v : nanf("");
        }
      }
    }
    cur = nxt;
  }
}

template <int BQ, int CB, bool EST, typename QT>
cudaError_t launch_lanes_shape(const QT* q, const uint8_t* codes, const int64_t* ids,
                               const float* norms, const float* ip_bar, float* out, int B, int N,
                               int d, int64_t n_table, int lpr_log2, int blocks_cap,
                               cudaStream_t stream) {
  const int chunks = d / (8 * CB);
  const size_t smem =
      (static_cast<size_t>(BQ) * (d + 4 * chunks) + BQ * (kThreads / 32)) * sizeof(float);
  auto kernel = binary_lanes_kernel<BQ, CB, EST, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int rows_per_block = kThreads >> lpr_log2;
  const int64_t blocks = (static_cast<int64_t>(N) + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(blocks < blocks_cap ? blocks : blocks_cap),
                  (B + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table,
                                           lpr_log2);
  return cudaGetLastError();
}

// Lanes a row and bytes a chunk.  When N gives every lane of the capped
// grid a row of its own, one lane takes a row (the whole warp then reads
// the same Q words, one shared-memory broadcast each) and the widest
// chunks; otherwise (the search path's flushes) the widest chunks that
// still give a row 8 lanes or more, so that each lane's products are short.
template <int BQ, bool EST, typename QT>
cudaError_t launch_lanes(const QT* q, const uint8_t* codes, const int64_t* ids, const float* norms,
                         const float* ip_bar, float* out, int B, int N, int d, int64_t n_table,
                         int device, cudaStream_t stream) {
  const int row_bytes = d / 8;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const int cap = kBlocksPerSm * sm_count(device);
  const bool one_lane = static_cast<int64_t>(N) >= static_cast<int64_t>(cap) * kThreads;
  int cb = 1;
  for (int c : {4, 2}) {
    if (row_bytes % c == 0 && base % c == 0 && (one_lane || row_bytes / c >= 8)) {
      cb = c;
      break;
    }
  }
  int lpr_log2 = 0;
  while (!one_lane && (1 << lpr_log2) < row_bytes / cb && lpr_log2 < 5) ++lpr_log2;
  if (cb == 4)
    return launch_lanes_shape<BQ, 4, EST>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table,
                                          lpr_log2, cap, stream);
  if (cb == 2)
    return launch_lanes_shape<BQ, 2, EST>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table,
                                          lpr_log2, cap, stream);
  return launch_lanes_shape<BQ, 1, EST>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table,
                                        lpr_log2, cap, stream);
}

// ------------------------------------------------------------ tensor-core path

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMT = 4;                       // 16-row m-tiles a warp takes at once
constexpr int kTileRows = 16 * kMT;          // rows a warp takes at once
constexpr int kStageStride = kTileRows + 4;  // staged output row: 8 lanes x 4 t on 32 banks

// bits p and p + 16 of a code word as a pair of bf16 signs (bit p in the
// low half): +1 (0x3F80) where the bit is set, -1 (0xBF80) where not, as
// 0xBF80BF80 - (w & bits) * 2^(15 - p) modulo 2^32 (a set bit takes 0x8000
// off its half; no borrow crosses a half).  Two instructions, an AND and
// one multiply-add with the constant in a register (bf16_neg1), written in
// PTX: C++ shifts and ORs compile to three, the AND, a shift and a LOP3
// that cannot take a second immediate.
__device__ __forceinline__ uint32_t sign_pair(uint32_t w, int p, uint32_t bf16_neg1) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(w & (0x00010001u << p)), "r"(0u - (1u << (15 - p))), "r"(bf16_neg1));
  return r;
}

// What a lane needs of one 64-row tile: its word of the first 128 dims of
// rows g and g + 8 of each m-tile, which of them exist, and the norms and
// ip_bar of rows g and g + 8 of m-tile t (the four lanes of a row share
// them by shuffles: one load a row, not four).
static_assert(kMT == 4, "lane t loads the norms of m-tile t");
template <bool EST>
struct TileLoad {
  uint32_t w[kMT][2];
  float x[2], ib[2];
  uint32_t ok;  // bit 2i + h: row 16i + 8h + g exists and its id is in the table
};

// The id of a tile's row (through ids, IDS; or the row itself, which a
// sweep's table, n_table == N, holds) and whether it names a row of the
// table.  Reads are clamped (to row N - 1, an unusable id to row 0) so
// that every load of a tile is issued unconditionally, with no branch.
template <bool IDS>
__device__ __forceinline__ int64_t tile_src(int row, int N, const int64_t* __restrict__ ids,
                                            int64_t n_table, bool& ok) {
  const int rc = row < N ? row : N - 1;
  if constexpr (IDS) {
    const int64_t s = ids[rc];
    ok = row < N && s >= 0 && s < n_table;
    return ok ? s : 0;
  }
  ok = row < N;
  return rc;
}

template <bool EST, bool IDS>
__device__ __forceinline__ TileLoad<EST> fetch_tile(int tile, int N,
                                                    const int64_t* __restrict__ ids,
                                                    const uint32_t* __restrict__ codes,
                                                    const float* __restrict__ norms,
                                                    const float* __restrict__ ip_bar,
                                                    int64_t n_table, int words, int g, int t) {
  TileLoad<EST> r;
  int64_t src[kMT][2];
  bool ok[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      src[i][h] = tile_src<IDS>(tile * kTileRows + 16 * i + 8 * h + g, N, ids, n_table, ok[i][h]);
  }
  const int tw = t < words ? t : 0;
  r.ok = 0u;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w = codes[src[i][h] * words + tw];
      r.ok |= static_cast<uint32_t>(ok[i][h]) << (2 * i + h);
      r.w[i][h] = ok[i][h] && t < words ? w : 0u;
      if (i == 0) r.x[h] = r.ib[h] = 0.f;
      if constexpr (EST) {
        if (i == t) {
          r.x[h] = norms[src[i][h]];
          r.ib[h] = ip_bar[src[i][h]];
        }
      }
    }
  }
  return r;
}

template <int TERMS, bool EST, bool IDS, typename QT>
__global__ void __launch_bounds__(kMmaThreads) binary_mma_kernel(
    const QT* __restrict__ q, const uint32_t* __restrict__ codes,
    const int64_t* __restrict__ ids, const float* __restrict__ norms,
    const float* __restrict__ ip_bar, float* __restrict__ out, int B, int N, int d,
    int64_t n_table) {
  extern __shared__ float4 smem4[];
  const int words = d / 32, groups = (words + 3) / 4;  // a row's words; 128-dim groups
  uint32_t* bfr = reinterpret_cast<uint32_t*>(smem4);  // (groups, TERMS, 16, 32) B fragments
  float* stage = reinterpret_cast<float*>(bfr + groups * TERMS * 512);  // (warps, 8, stride)
  float* qn2 = stage + kMmaWarps * 8 * kStageStride;                     // (8,) ||q_b||^2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b0 = blockIdx.y * 8;
  const int tiles = (N + kTileRows - 1) / kTileRows;
  const int tstride = gridDim.x * kMmaWarps;
  int tile = blockIdx.x * kMmaWarps + warp;

  TileLoad<EST> cur =
      fetch_tile<EST, IDS>(tile, N, ids, codes, norms, ip_bar, n_table, words, g, t);

  // Q's B fragments in the permuted dim order: register r of lane (g, t) in
  // group c is the pair (q_g[128c + 32t + r], q_g[128c + 32t + r + 16]),
  // split into TERMS bf16 terms; k-step s reads registers 2s and 2s + 1
  for (int i = threadIdx.x; i < groups * 512; i += kMmaThreads) {
    const int ln = i % 32, r = (i / 32) % 16, c = i / 512;
    const int k = 128 * c + 32 * (ln % 4) + r, b = b0 + ln / 4;
    float x0 = 0.f, x1 = 0.f;
    if (b < B && k < d) {  // d % 32 == 0: then k + 16 < d too
      x0 = to_f32(q[static_cast<int64_t>(b) * d + k]);
      x1 = to_f32(q[static_cast<int64_t>(b) * d + k + 16]);
    }
#pragma unroll
    for (int term = 0; term < TERMS; ++term) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      bfr[((c * TERMS + term) * 16 + r) * 32 + ln] = *reinterpret_cast<const uint32_t*>(&h);
      x0 -= __low2float(h);
      x1 -= __high2float(h);
    }
  }
  if constexpr (EST) {
    for (int b = warp; b < 8; b += kMmaWarps) {
      float s[1] = {0.f};
      if (b0 + b < B) {
        for (int k = lane; k < d; k += 32) {
          const float x = to_f32(q[static_cast<int64_t>(b0 + b) * d + k]);
          s[0] = fmaf(x, x, s[0]);
        }
      }
      lane_sum(s, 32);
      if (lane == 0) qn2[b] = s[0];
    }
  }
  __syncthreads();
  float qn[2], sc[2];  // this lane's output queries 2t, 2t + 1 (the estimate entry)
  if constexpr (EST) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      qn[e] = sqrtf(qn2[2 * t + e]);
      sc[e] = est_scale(qn[e], d);
    }
  }
  float* st = stage + warp * 8 * kStageStride;
  const bool vec_out = N % 4 == 0;

  for (; tile < tiles; tile += tstride) {
    float tot[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][e] = 0.f;
    }
    for (int c = 0; c < groups; ++c) {
      uint32_t w[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          w[i][h] = cur.w[i][h];
          if (c > 0) {  // d > 128: this group's word, the id again from L1
            bool ok;
            const int64_t src =
                tile_src<IDS>(tile * kTileRows + 16 * i + 8 * h + g, N, ids, n_table, ok);
            const bool in_row = 4 * c + t < words;
            const uint32_t v = codes[src * words + (in_row ? 4 * c + t : 0)];
            w[i][h] = ok && in_row ? v : 0u;
          }
        }
      }
      float hi[kMT][4], lo[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[i][e] = lo[i][e] = 0.f;
      }
      const uint32_t* bc = bfr + c * TERMS * 512 + lane;
      uint32_t neg1;  // 0xBF80BF80, held in a register (see sign_pair)
      asm volatile("mov.b32 %0, 0xBF80BF80;" : "=r"(neg1));
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        uint32_t a[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          a[i][0] = sign_pair(w[i][0], 2 * s, neg1);      // k slots 2t, 2t + 1 of row g
          a[i][1] = sign_pair(w[i][1], 2 * s, neg1);      // the same of row g + 8
          a[i][2] = sign_pair(w[i][0], 2 * s + 1, neg1);  // k slots 2t + 8, 2t + 9
          a[i][3] = sign_pair(w[i][1], 2 * s + 1, neg1);
        }
#pragma unroll
        for (int term = 0; term < TERMS; ++term) {
          const uint32_t f0 = bc[(term * 16 + 2 * s) * 32], f1 = bc[(term * 16 + 2 * s + 1) * 32];
#pragma unroll
          for (int i = 0; i < kMT; ++i) mma_bf16_16816(term == 0 ? hi[i] : lo[i], a[i], f0, f1);
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][e] += hi[i][e] + lo[i][e];
      }
    }

    // the estimate in registers; accumulator element 2h + e is row
    // 16i + 8h + g, query 2t + e; staged (query, row) for wide stores
    float rib[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rib[h] = EST ? inv_ip_bar(cur.ib[h]) : 0.f;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = 0.f, ri = 0.f;
        if constexpr (EST) {  // from lane (g, i), which loaded them
          x = __shfl_sync(0xffffffffu, cur.x[h], 4 * g + i);
          ri = __shfl_sync(0xffffffffu, rib[h], 4 * g + i);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = tot[i][2 * h + e];
          if constexpr (EST) v = estimate(v, qn[e], sc[e], x, ri);
          // an id outside the table gives NaN; a sweep's rows past N are
          // never stored
          if constexpr (IDS) v = (cur.ok >> (2 * i + h)) & 1u ? v : nanf("");
          st[(2 * t + e) * kStageStride + 16 * i + 8 * h + g] = v;
        }
      }
    }
    __syncwarp();
    const int r0 = tile * kTileRows;
#pragma unroll
    for (int m = 0; m < 8 * kTileRows / 4 / 32; ++m) {
      const int k = lane + 32 * m, qq = k / (kTileRows / 4), jj = k % (kTileRows / 4);
      const int row = r0 + 4 * jj;
      if (b0 + qq < B && row < N) {
        const float4 v = *reinterpret_cast<const float4*>(st + qq * kStageStride + 4 * jj);
        float* o = out + static_cast<int64_t>(b0 + qq) * N + row;
        if (vec_out) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          o[0] = v.x;
          if (row + 1 < N) o[1] = v.y;
          if (row + 2 < N) o[2] = v.z;
          if (row + 3 < N) o[3] = v.w;
        }
      }
    }
    __syncwarp();
    // the next tile's loads: issued here and not a tile ahead, which would
    // hold a second tile's registers and cost more in occupancy than the
    // overlap gains (the variant measures it)
    if (tile + tstride < tiles)
      cur = fetch_tile<EST, IDS>(tile + tstride, N, ids, codes, norms, ip_bar, n_table, words, g,
                                 t);
  }
}

template <bool EST, bool IDS, typename QT>
cudaError_t launch_mma(const QT* q, const uint8_t* codes, const int64_t* ids, const float* norms,
                       const float* ip_bar, float* out, int B, int N, int d, int64_t n_table,
                       int device, cudaStream_t stream) {
  constexpr int TERMS = sizeof(QT) == 4 ? 3 : 1;  // fp32: three bf16 terms; bf16: itself
  const int groups = (d / 32 + 3) / 4;
  const size_t smem = static_cast<size_t>(groups) * TERMS * 512 * sizeof(uint32_t) +
                      (kMmaWarps * 8 * kStageStride + 8) * sizeof(float);
  auto kernel = binary_mma_kernel<TERMS, EST, IDS, QT>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err != cudaSuccess) return err;
  const int qblocks = (B + 7) / 8;
  int cap = per_sm * sm_count(device) / qblocks;
  if (cap < 1) cap = 1;
  const int64_t tiles = (static_cast<int64_t>(N) + kTileRows - 1) / kTileRows;
  const int64_t blocks = (tiles + kMmaWarps - 1) / kMmaWarps;
  const dim3 grid(static_cast<unsigned>(blocks < cap ? blocks : cap), qblocks);
  kernel<<<grid, kMmaThreads, smem, stream>>>(q, reinterpret_cast<const uint32_t*>(codes), ids,
                                              norms, ip_bar, out, B, N, d, n_table);
  return cudaGetLastError();
}

template <bool EST, typename QT>
int launch(const QT* q, const uint8_t* codes, const float* norms, const float* ip_bar,
           const int64_t* ids, float* out, int B, int N, int d, int64_t n_table,
           int tensor_cores, int device, void* stream_ptr) {
  if (d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_cores && (d % 32 != 0 || reinterpret_cast<uintptr_t>(codes) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (tensor_cores && ids)
    err = launch_mma<EST, true>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table, device, s);
  else if (tensor_cores)  // a sweep: row n is codes[n], n_table == N
    err = launch_mma<EST, false>(q, codes, ids, norms, ip_bar, out, B, N, d, N, device, s);
  else if (B >= 8)
    err = launch_lanes<8, EST>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table, device, s);
  else if (B >= 4)
    err = launch_lanes<4, EST>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table, device, s);
  else if (B >= 2)
    err = launch_lanes<2, EST>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table, device, s);
  else
    err = launch_lanes<1, EST>(q, codes, ids, norms, ip_bar, out, B, N, d, n_table, device, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entries for ctypes.  q is (B, d) row-major, codes (n_table, d/8)
// uint8 row-major, ids (N,) int64 or NULL (row n is codes[n]), norms and
// ip_bar (n_table,) float32, out (B, N) float32.  tensor_cores != 0 takes
// the tensor-core path, which needs d % 32 == 0 and 4-byte aligned codes;
// 0 the lanes path, which takes any d % 8 == 0.  Each returns the launch's
// cudaError_t; 0 is success.
extern "C" int binary_ip_f32(const float* q, const uint8_t* codes, const int64_t* ids, float* out,
                             int B, int N, int d, int64_t n_table, int tensor_cores, int device,
                             void* stream) {
  return launch<false>(q, codes, nullptr, nullptr, ids, out, B, N, d, n_table, tensor_cores,
                       device, stream);
}

extern "C" int binary_ip_bf16(const __nv_bfloat16* q, const uint8_t* codes, const int64_t* ids,
                              float* out, int B, int N, int d, int64_t n_table, int tensor_cores,
                              int device, void* stream) {
  return launch<false>(q, codes, nullptr, nullptr, ids, out, B, N, d, n_table, tensor_cores,
                       device, stream);
}

extern "C" int binary_est_f32(const float* q, const uint8_t* codes, const float* norms,
                              const float* ip_bar, const int64_t* ids, float* out, int B, int N,
                              int d, int64_t n_table, int tensor_cores, int device, void* stream) {
  return launch<true>(q, codes, norms, ip_bar, ids, out, B, N, d, n_table, tensor_cores, device,
                      stream);
}

extern "C" int binary_est_bf16(const __nv_bfloat16* q, const uint8_t* codes, const float* norms,
                               const float* ip_bar, const int64_t* ids, float* out, int B, int N,
                               int d, int64_t n_table, int tensor_cores, int device,
                               void* stream) {
  return launch<true>(q, codes, norms, ip_bar, ids, out, B, N, d, n_table, tensor_cores, device,
                      stream);
}
