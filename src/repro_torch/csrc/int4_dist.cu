// int4_dist: out[b, n] = ||q_b||^2 - 2 <q_b, x_n> + ||x_n||^2 with
// x_n = nibble(codes[row_n]) * step[row_n] + lo[row_n], the level-2 refine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/int4_dist/kernel.py
// (_int4_dist_kernel, driven by int4_dist_pallas), which dequantises in VMEM
// right before the MXU contraction.
//
// What bounds it on the H100.  A code row is d/2 + 8 bytes and costs about
// 2*B*d flops, about 4*B flops a byte against the fp32 ridge of 20: bytes
// bound it up to B = 5 and fp32 FMA issue above.  On the search path
// (B <= 8 queries, N ~ 64-256 ids gathered from a resident table or the HBM
// slot mirror, d = 128) one call moves about 20 KB, so neither does: the
// call is latency.  Two dependent global loads (the id, then the code row)
// are its critical path, and whatever runs before them or serialises after
// them adds to it.
//
// Design.  Several lanes per code row: a row of d/2 bytes is cut into
// chunks of VB bytes (the widest of 16, 8, 4 that the row, the table's
// alignment and at least 8 chunks allow), and the LPR lanes of a row (the
// power of two >= the chunk count, at most 32: 8 at d = 128, 32 at
// d = 960) each take chunks j, j + LPR, ...  Small blocks (64 threads, 8
// rows at d = 128) spread N = 256 over 32 SMs.  Loads come first: each
// lane reads the id, then its first chunk, lo and step, before anything
// else.  Only then is Q staged in
// shared memory with 16-byte loads (rows padded by 4 floats a chunk, so
// the lanes of a row read distinct banks), and ||q_b||^2 and sum(q_b) are
// reduced from the values staged (shuffles, then one word a warp) behind
// the one barrier: there is no second pass over Q.  The dequant is
// algebraic: with c the nibbles,
//   <q, c step + lo> = step <q, c> + lo sum(q),
//   ||x||^2 = step^2 sum(c^2) + 2 step lo sum(c) + d lo^2,
// where sum(c) and sum(c^2) are integer sums (__dp4a, four nibbles an
// instruction; exact in fp32 below 2^24, up to d = 74 565), so the
// per-dimension work is B FMAs and one byte-to-float, and the 128-deep
// ||x||^2 chain is gone.  The LPR partial sums of a row (B inner products,
// sum(c), sum(c^2)) meet by __shfl_xor_sync, and lane j writes queries j,
// j + LPR, ...  For large N (the 1M sweep) the grid is capped at 16 blocks an SM,
// warps stride over rows with the next row's loads issued before the
// current row's products, and one lane takes a row: the lanes of a warp
// then read the same Q words, one shared-memory broadcast each, where
// several lanes a row would read several (4x the shared-memory traffic).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;       // threads per block
constexpr int kBlocksPerSm = 16;   // grid cap for large N, in blocks an SM

template <int VB>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[VB / 4]) {
  if constexpr (VB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// byte k of a word of nibbles (each byte 0..15) as a float, exactly: the
// byte under an exponent of 2^23 is 2^23 + n
__device__ __forceinline__ float byte_as_float(uint32_t nibbles, int k) {
  return __uint_as_float(__byte_perm(nibbles, 0x4B000000u, 0x7540 + k)) - 8388608.f;
}

// What a lane needs of one code row: read before anything else is done.
template <int VB>
struct RowLoad {
  uint32_t w[VB / 4];  // this lane's first chunk
  float lo, step;
  bool ok;             // the row exists and its id is inside the table
};

template <int VB>
__device__ __forceinline__ RowLoad<VB> fetch_row(int row, int N, const int64_t* __restrict__ ids,
                                                 const uint8_t* __restrict__ codes,
                                                 const float* __restrict__ lo,
                                                 const float* __restrict__ step, int64_t n_table,
                                                 int row_bytes, int j, int chunks) {
  RowLoad<VB> r;
  const int64_t src = row < N ? (ids ? ids[row] : row) : -1;
  r.ok = src >= 0 && src < n_table;
  r.lo = r.step = 0.f;
#pragma unroll
  for (int i = 0; i < VB / 4; ++i) r.w[i] = 0u;
  if (r.ok) {
    if (j < chunks) load_words<VB>(codes + src * row_bytes + j * VB, r.w);
    r.lo = lo[src];
    r.step = step[src];
  }
  return r;
}

// The low nibble of byte i is dimension 2*i and the high nibble 2*i + 1.
// sum(c) and sum(c^2) are taken four bytes at a time by __dp4a, in uint32.
// qc points at the chunk's first dimension of query 0; qs is Q's row stride.
template <int BQ, int VB>
__device__ __forceinline__ void accumulate(const uint32_t (&w)[VB / 4], const float* qc, int qs,
                                           float (&ip)[BQ], uint32_t& cs, uint32_t& cq) {
#pragma unroll
  for (int i = 0; i < VB / 4; ++i) {
    const uint32_t lw = w[i] & 0x0F0F0F0Fu, hw = (w[i] >> 4) & 0x0F0F0F0Fu;
    cs = __dp4a(lw, 0x01010101u, __dp4a(hw, 0x01010101u, cs));
    cq = __dp4a(lw, lw, __dp4a(hw, hw, cq));
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // dims 8i + 4h .. + 3: bytes 2h and 2h + 1
      const float x0 = byte_as_float(lw, 2 * h), x1 = byte_as_float(hw, 2 * h);
      const float x2 = byte_as_float(lw, 2 * h + 1), x3 = byte_as_float(hw, 2 * h + 1);
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        const float4 qv = *reinterpret_cast<const float4*>(qc + b * qs + 8 * i + 4 * h);
        ip[b] = fmaf(qv.x, x0, fmaf(qv.y, x1, fmaf(qv.z, x2, fmaf(qv.w, x3, ip[b]))));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void lane_sum(float (&v)[N], int lpr) {
  for (int o = lpr / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

template <int BQ, int VB>
__global__ void __launch_bounds__(kThreads) int4_dist_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ codes,
    const float* __restrict__ lo, const float* __restrict__ step,
    const int64_t* __restrict__ ids, float* __restrict__ out,
    int B, int N, int d, int64_t n_table, int lpr_log2) {
  constexpr int CD = VB * 2;  // dimensions a chunk
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // (warps, 2 BQ) partial ||q_b||^2, sum(q_b)
  float* qsm = red + 2 * BQ * (kThreads / 32);   // (BQ, QS), 4 pad floats a chunk
  const int chunks = d / CD, row_bytes = d / 2;
  const int QS = d + 4 * chunks;
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x % 32, j = lane & (lpr - 1);
  // rows advance a warp at a time, so every lane of a warp runs every
  // iteration and the shuffles see the whole warp
  const int rows_per_warp = 32 >> lpr_log2;
  const int stride = gridDim.x * (kThreads >> lpr_log2);
  const int base0 = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * rows_per_warp;
  const int in_warp = lane >> lpr_log2;
  const int b0 = blockIdx.y * BQ;

  RowLoad<VB> cur = fetch_row<VB>(base0 + in_warp, N, ids, codes, lo, step, n_table, row_bytes,
                                  j, chunks);

  // stage Q (16-byte loads, all of a thread's issued before any store) and
  // take ||q_b||^2 and sum(q_b) of what this thread staged
  float qp[2 * BQ];
#pragma unroll
  for (int i = 0; i < 2 * BQ; ++i) qp[i] = 0.f;
  const bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (int k0 = 0; k0 < d; k0 += 4 * kThreads) {
    const int k = k0 + 4 * threadIdx.x;
    float4 v[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < d && b0 + b < B) {
        const float* src = q + static_cast<int64_t>(b0 + b) * d + k;
        v[b] = vec ? *reinterpret_cast<const float4*>(src)
                   : make_float4(src[0], src[1], src[2], src[3]);
      }
    }
    if (k < d) {
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        *reinterpret_cast<float4*>(qsm + b * QS + k + 4 * (k / CD)) = v[b];
        qp[b] = fmaf(v[b].x, v[b].x, fmaf(v[b].y, v[b].y, fmaf(v[b].z, v[b].z,
                fmaf(v[b].w, v[b].w, qp[b]))));
        qp[BQ + b] += (v[b].x + v[b].y) + (v[b].z + v[b].w);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 2 * BQ; ++i) qp[i] += __shfl_xor_sync(0xffffffffu, qp[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2 * BQ; ++i) red[(threadIdx.x / 32) * 2 * BQ + i] = qp[i];
  }
  __syncthreads();
  float qn[2 * BQ];  // ||q_b||^2, then sum(q_b)
#pragma unroll
  for (int i = 0; i < 2 * BQ; ++i) {
    qn[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) qn[i] += red[w * 2 * BQ + i];
  }
  const float fd = static_cast<float>(d);

  for (int base = base0; base < N; base += stride) {
    const int row = base + in_warp;
    const RowLoad<VB> nxt = fetch_row<VB>(base + stride + in_warp, N, ids, codes, lo, step,
                                          n_table, row_bytes, j, chunks);
    float acc[BQ + 2];  // <q_b, c> for each b, then sum(c), sum(c^2)
#pragma unroll
    for (int i = 0; i < BQ + 2; ++i) acc[i] = 0.f;
    if (cur.ok) {
      float ip[BQ];
#pragma unroll
      for (int b = 0; b < BQ; ++b) ip[b] = 0.f;
      uint32_t cs = 0u, cq = 0u;
      if (j < chunks) accumulate<BQ, VB>(cur.w, qsm + j * (CD + 4), QS, ip, cs, cq);
      const int64_t src = ids ? ids[row] : row;  // in L1: read by fetch_row
      for (int c = j + lpr; c < chunks; c += lpr) {
        uint32_t w[VB / 4];
        load_words<VB>(codes + src * row_bytes + c * VB, w);
        accumulate<BQ, VB>(w, qsm + c * (CD + 4), QS, ip, cs, cq);
      }
#pragma unroll
      for (int b = 0; b < BQ; ++b) acc[b] = ip[b];
      acc[BQ] = static_cast<float>(cs);  // exact below 2^24
      acc[BQ + 1] = static_cast<float>(cq);
    }
    lane_sum(acc, lpr);
    if (row < N) {
      const float st = cur.step, l = cur.lo;
      const float xn = fmaf(st * st, acc[BQ + 1], fmaf(2.f * st * l, acc[BQ], fd * l * l));
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        if ((b & (lpr - 1)) == j && b0 + b < B) {
          const float ipx = fmaf(st, acc[b], l * qn[BQ + b]);  // <q_b, x>
          out[static_cast<int64_t>(b0 + b) * N + row] =
              cur.ok ? (qn[b] - 2.f * ipx) + xn : nanf("");  // an id outside the table
        }
      }
    }
    cur = nxt;
  }
}

template <int BQ, int VB>
cudaError_t launch_shape(const float* q, const uint8_t* codes, const float* lo, const float* step,
                         const int64_t* ids, float* out, int B, int N, int d, int64_t n_table,
                         int lpr_log2, int blocks_cap, cudaStream_t stream) {
  const int chunks = d / (2 * VB);
  const size_t smem = (2 * BQ * (kThreads / 32) + static_cast<size_t>(BQ) * (d + 4 * chunks)) *
                      sizeof(float);
  auto kernel = int4_dist_kernel<BQ, VB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int rows_per_block = kThreads >> lpr_log2;
  const int64_t blocks = (static_cast<int64_t>(N) + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(blocks < blocks_cap ? blocks : blocks_cap),
                  (B + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(q, codes, lo, step, ids, out, B, N, d, n_table,
                                           lpr_log2);
  return cudaGetLastError();
}

// Lanes a row and bytes a chunk.  When N gives every lane of the capped
// grid a row of its own, one lane takes a row (the whole warp then reads
// the same Q words, one shared-memory broadcast each) and the widest
// chunks; otherwise (the search path's flushes) the widest chunks that
// still give a row 8 lanes or more, so that each lane's products are short.
template <int BQ>
cudaError_t launch_bq(const float* q, const uint8_t* codes, const float* lo, const float* step,
                      const int64_t* ids, float* out, int B, int N, int d, int64_t n_table,
                      int device, cudaStream_t stream) {
  const int row_bytes = d / 2;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const int cap = kBlocksPerSm * sm_count(device);
  const bool one_lane = static_cast<int64_t>(N) >= static_cast<int64_t>(cap) * kThreads;
  int vb = 4;
  for (int c : {16, 8}) {
    if (row_bytes % c == 0 && base % c == 0 && (one_lane || row_bytes / c >= 8)) {
      vb = c;
      break;
    }
  }
  int lpr_log2 = 0;
  while (!one_lane && (1 << lpr_log2) < row_bytes / vb && lpr_log2 < 5) ++lpr_log2;
  if (vb == 16)
    return launch_shape<BQ, 16>(q, codes, lo, step, ids, out, B, N, d, n_table, lpr_log2, cap,
                                stream);
  if (vb == 8)
    return launch_shape<BQ, 8>(q, codes, lo, step, ids, out, B, N, d, n_table, lpr_log2, cap,
                               stream);
  return launch_shape<BQ, 4>(q, codes, lo, step, ids, out, B, N, d, n_table, lpr_log2, cap,
                             stream);
}

}  // namespace

// Plain C entry for ctypes.  q is (B, d) float32 row-major, codes
// (n_table, d/2) uint8 row-major with the low nibble the even dimension, lo
// and step (n_table,) float32, ids (N,) int64 or NULL (row n is codes[n]),
// out (B, N) float32.  d must be a multiple of 8 and the codes pointer
// 4-byte aligned.  Returns the launch's cudaError_t; 0 is success.
extern "C" int int4_dist_f32(const float* q, const uint8_t* codes, const float* lo,
                             const float* step, const int64_t* ids, float* out, int B, int N,
                             int d, int64_t n_table, int device, void* stream) {
  if (d <= 0 || d % 8 != 0 || reinterpret_cast<uintptr_t>(codes) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B >= 8) err = launch_bq<8>(q, codes, lo, step, ids, out, B, N, d, n_table, device, s);
  else if (B >= 4) err = launch_bq<4>(q, codes, lo, step, ids, out, B, N, d, n_table, device, s);
  else if (B >= 2) err = launch_bq<2>(q, codes, lo, step, ids, out, B, N, d, n_table, device, s);
  else err = launch_bq<1>(q, codes, lo, step, ids, out, B, N, d, n_table, device, s);
  return static_cast<int>(err);
}
