// int4_dist: out[b, n] = ||q_b||^2 - 2 <q_b, x_n> + ||x_n||^2 with
// x_n = nibble(codes[row_n]) * step[row_n] + lo[row_n], the level-2 refine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/int4_dist/kernel.py
// (_int4_dist_kernel, driven by int4_dist_pallas), which dequantises in VMEM
// right before the MXU contraction.
//
// What bounds it on the H100.  A code row is d/2 + 8 bytes and costs about
// 2*B*d + 4*d flops, about 4*B + 8 flops a byte against the fp32 ridge of
// 20: bytes bound it (d/2 + 8 bytes a row at 3.35 TB/s) up to B = 3 and fp32
// FMA issue above.  On the search path (B <= 8, N ~ 64-256 rows, d = 128) one call
// moves about 20 KB, so the launch bounds it, as for binary_ip.
//
// Design.  The structure of binary_ip.cu: one thread per code row, 128 rows
// a block, the BQ query rows staged in shared memory, the row read through
// the optional id (or HBM-slot) vector with 16-byte loads, so the gather is
// folded into the load.  The thread dequantises x = code*step + lo in
// registers (only d/2 bytes of codes ever leave device memory, as on the
// TPU) and accumulates <q_b, x> and ||x||^2 in IEEE fp32 FMA.  ||q_b||^2 is
// reduced once per block by one warp per query, not once per row.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 128;  // code rows per block, one per thread

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

__device__ __forceinline__ float dequant(uint32_t word, int nib, float step, float lo) {
  return fmaf(static_cast<float>((word >> (4 * nib)) & 15u), step, lo);
}

// The low nibble of byte i is dimension 2*i and the high nibble 2*i + 1, so
// nibble t of a little-endian word is dimension t past the word's first.
template <int BQ, int VB>
__global__ void __launch_bounds__(kRows) int4_dist_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ codes,
    const float* __restrict__ lo, const float* __restrict__ step,
    const int64_t* __restrict__ ids, float* __restrict__ out,
    int B, int N, int d, int64_t n_table) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (BQ, d), zero rows past B
  float* qn = qs + BQ * d;                      // (BQ,) ||q_b||^2
  const int b0 = blockIdx.y * BQ;
  for (int i = threadIdx.x; i < BQ * d; i += blockDim.x) {
    const int b = i / d;
    qs[i] = (b0 + b < B) ? q[static_cast<int64_t>(b0 + b) * d + (i - b * d)] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < BQ; b += kRows / 32) {
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s = fmaf(qs[b * d + k], qs[b * d + k], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) qn[b] = s;
  }
  __syncthreads();

  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= N) return;
  const int64_t src = ids ? ids[row] : row;
  float ip[BQ];
#pragma unroll
  for (int b = 0; b < BQ; ++b) ip[b] = 0.f;
  float xn = 0.f;

  if (src < 0 || src >= n_table) {
    // an id outside the table reads nothing and yields NaN
    xn = nanf("");
  } else {
    const float lo_r = lo[src], step_r = step[src];
    const int row_bytes = d / 2;
    const uint8_t* crow = codes + src * row_bytes;
    for (int off = 0; off < row_bytes; off += VB) {
      uint32_t w[VB / 4];
      load_words<VB>(crow + off, w);
      const float* qk = qs + off * 2;  // first dimension of these VB bytes
#pragma unroll
      for (int t = 0; t < VB * 2; t += 4) {
        const uint32_t word = w[t / 8];
        const float x0 = dequant(word, t % 8, step_r, lo_r);
        const float x1 = dequant(word, t % 8 + 1, step_r, lo_r);
        const float x2 = dequant(word, t % 8 + 2, step_r, lo_r);
        const float x3 = dequant(word, t % 8 + 3, step_r, lo_r);
        xn = fmaf(x0, x0, xn);
        xn = fmaf(x1, x1, xn);
        xn = fmaf(x2, x2, xn);
        xn = fmaf(x3, x3, xn);
#pragma unroll
        for (int b = 0; b < BQ; ++b) {
          const float4 qv = *reinterpret_cast<const float4*>(qk + b * d + t);
          ip[b] = fmaf(qv.x, x0, ip[b]);
          ip[b] = fmaf(qv.y, x1, ip[b]);
          ip[b] = fmaf(qv.z, x2, ip[b]);
          ip[b] = fmaf(qv.w, x3, ip[b]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BQ; ++b) {
    if (b0 + b < B) out[static_cast<int64_t>(b0 + b) * N + row] = (qn[b] - 2.f * ip[b]) + xn;
  }
}

template <int BQ, int VB>
cudaError_t launch_shape(const float* q, const uint8_t* codes, const float* lo, const float* step,
                         const int64_t* ids, float* out, int B, int N, int d, int64_t n_table,
                         cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(BQ) * d + BQ) * sizeof(float);
  auto kernel = int4_dist_kernel<BQ, VB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kRows - 1) / kRows, (B + BQ - 1) / BQ);
  kernel<<<grid, kRows, smem, stream>>>(q, codes, lo, step, ids, out, B, N, d, n_table);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t launch_bq(const float* q, const uint8_t* codes, const float* lo, const float* step,
                      const int64_t* ids, float* out, int B, int N, int d, int64_t n_table,
                      cudaStream_t stream) {
  const int row_bytes = d / 2;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  if (row_bytes % 16 == 0 && base % 16 == 0)
    return launch_shape<BQ, 16>(q, codes, lo, step, ids, out, B, N, d, n_table, stream);
  if (row_bytes % 8 == 0 && base % 8 == 0)
    return launch_shape<BQ, 8>(q, codes, lo, step, ids, out, B, N, d, n_table, stream);
  return launch_shape<BQ, 4>(q, codes, lo, step, ids, out, B, N, d, n_table, stream);
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
  if (B >= 8) err = launch_bq<8>(q, codes, lo, step, ids, out, B, N, d, n_table, s);
  else if (B >= 4) err = launch_bq<4>(q, codes, lo, step, ids, out, B, N, d, n_table, s);
  else if (B >= 2) err = launch_bq<2>(q, codes, lo, step, ids, out, B, N, d, n_table, s);
  else err = launch_bq<1>(q, codes, lo, step, ids, out, B, N, d, n_table, s);
  return static_cast<int>(err);
}
