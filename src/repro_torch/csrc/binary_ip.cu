// binary_ip: out[b, n] = <q_b, 2 * bit(codes[row_n]) - 1>, the sign product
// under RaBitQ's level-1 distance estimate.
//
// Replaces the Pallas TPU kernel src/repro/kernels/binary_ip/kernel.py
// (_binary_ip_kernel, driven by binary_ip_pallas), which unpacks the codes in
// VMEM and feeds the 128x128 MXU.
//
// What bounds it on the H100.  A code row is d/8 bytes and costs 2*B*d flops,
// 16*B flops a byte; the fp32 ridge (67 TFLOP/s over 3.35 TB/s) is 20 flops a
// byte.  On the search path (B <= 8 queries, N ~ 64-256 rows, d = 128) one
// call moves about 16 KB and does under a MFLOP, which the card finishes in
// well under a microsecond: the launch bounds it.  On a full sweep of a
// 1M-row table it is bound by bytes at B = 1 (N*d/8 bytes at 3.35 TB/s) and
// by fp32 FMA issue from B = 2 on.
//
// Design.  One thread owns one code row; a block of 128 threads covers 128
// rows and stages its BQ query rows in shared memory (BQ*d*4 bytes: 30 KB at
// BQ = 8, d = 960).  A thread reads its row through the optional id vector,
// so the gather is folded into the load and the resident table is never
// copied, with 16-byte loads where the row length allows.  It unpacks the
// bits in registers and accumulates BQ sums in IEEE fp32 FMA (TF32 would
// miss the reference tolerance of rtol 1e-5).  Query values come from shared
// memory as float4 broadcasts, one load for four FMAs.  One launch serves
// the whole (B, N) call, so a search-path call costs one launch.  bf16
// queries are widened to fp32 on the way into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 128;  // code rows per block, one per thread

// Load VB bytes of a code row (VB in {16, 8, 4, 1}) as little-endian words.
template <int VB>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[(VB + 3) / 4]) {
  if constexpr (VB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (VB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *p;
  }
}

__device__ __forceinline__ float sign_of(uint32_t word, int bit) {
  return ((word >> bit) & 1u) ? 1.f : -1.f;
}

// Bit j of byte i is dimension 8*i + j (np.packbits, bitorder="little"), so
// bit t of a little-endian word is dimension t past the word's first.
template <int BQ, int VB, typename QT>
__global__ void __launch_bounds__(kRows) binary_ip_kernel(
    const QT* __restrict__ q, const uint8_t* __restrict__ codes,
    const int64_t* __restrict__ ids, float* __restrict__ out,
    int B, int N, int d, int64_t n_table) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (BQ, d), zero rows past B
  const int b0 = blockIdx.y * BQ;
  for (int i = threadIdx.x; i < BQ * d; i += blockDim.x) {
    const int b = i / d;
    qs[i] = (b0 + b < B) ? to_f32(q[static_cast<int64_t>(b0 + b) * d + (i - b * d)]) : 0.f;
  }
  __syncthreads();

  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= N) return;
  const int64_t src = ids ? ids[row] : row;
  float acc[BQ];
#pragma unroll
  for (int b = 0; b < BQ; ++b) acc[b] = 0.f;

  if (src < 0 || src >= n_table) {
    // an id outside the table reads nothing and yields NaN
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[b] = nanf("");
  } else {
    const int row_bytes = d / 8;
    const uint8_t* crow = codes + src * row_bytes;
    for (int off = 0; off < row_bytes; off += VB) {
      uint32_t w[(VB + 3) / 4];
      load_words<VB>(crow + off, w);
      const float* qk = qs + off * 8;  // first dimension of these VB bytes
#pragma unroll
      for (int t = 0; t < VB * 8; t += 4) {
        const uint32_t word = w[t / 32];
        const float s0 = sign_of(word, t % 32);
        const float s1 = sign_of(word, t % 32 + 1);
        const float s2 = sign_of(word, t % 32 + 2);
        const float s3 = sign_of(word, t % 32 + 3);
#pragma unroll
        for (int b = 0; b < BQ; ++b) {
          const float4 qv = *reinterpret_cast<const float4*>(qk + b * d + t);
          acc[b] = fmaf(qv.x, s0, acc[b]);
          acc[b] = fmaf(qv.y, s1, acc[b]);
          acc[b] = fmaf(qv.z, s2, acc[b]);
          acc[b] = fmaf(qv.w, s3, acc[b]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BQ; ++b) {
    if (b0 + b < B) out[static_cast<int64_t>(b0 + b) * N + row] = acc[b];
  }
}

template <int BQ, int VB, typename QT>
cudaError_t launch_shape(const QT* q, const uint8_t* codes, const int64_t* ids, float* out,
                         int B, int N, int d, int64_t n_table, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BQ) * d * sizeof(float);
  auto kernel = binary_ip_kernel<BQ, VB, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kRows - 1) / kRows, (B + BQ - 1) / BQ);
  kernel<<<grid, kRows, smem, stream>>>(q, codes, ids, out, B, N, d, n_table);
  return cudaGetLastError();
}

template <int BQ, typename QT>
cudaError_t launch_bq(const QT* q, const uint8_t* codes, const int64_t* ids, float* out,
                      int B, int N, int d, int64_t n_table, cudaStream_t stream) {
  const int row_bytes = d / 8;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  if (row_bytes % 16 == 0 && base % 16 == 0)
    return launch_shape<BQ, 16>(q, codes, ids, out, B, N, d, n_table, stream);
  if (row_bytes % 8 == 0 && base % 8 == 0)
    return launch_shape<BQ, 8>(q, codes, ids, out, B, N, d, n_table, stream);
  if (row_bytes % 4 == 0 && base % 4 == 0)
    return launch_shape<BQ, 4>(q, codes, ids, out, B, N, d, n_table, stream);
  return launch_shape<BQ, 1>(q, codes, ids, out, B, N, d, n_table, stream);
}

template <typename QT>
int launch(const QT* q, const uint8_t* codes, const int64_t* ids, float* out,
           int B, int N, int d, int64_t n_table, int device, cudaStream_t stream) {
  if (d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B >= 8) err = launch_bq<8>(q, codes, ids, out, B, N, d, n_table, stream);
  else if (B >= 4) err = launch_bq<4>(q, codes, ids, out, B, N, d, n_table, stream);
  else if (B >= 2) err = launch_bq<2>(q, codes, ids, out, B, N, d, n_table, stream);
  else err = launch_bq<1>(q, codes, ids, out, B, N, d, n_table, stream);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entries for ctypes.  q is (B, d) row-major, codes (n_table, d/8)
// uint8 row-major, ids (N,) int64 or NULL (row n is codes[n]), out (B, N)
// float32.  Each returns the launch's cudaError_t; 0 is success.
extern "C" int binary_ip_f32(const float* q, const uint8_t* codes, const int64_t* ids, float* out,
                             int B, int N, int d, int64_t n_table, int device, void* stream) {
  return launch(q, codes, ids, out, B, N, d, n_table, device, static_cast<cudaStream_t>(stream));
}

extern "C" int binary_ip_bf16(const __nv_bfloat16* q, const uint8_t* codes, const int64_t* ids,
                              float* out, int B, int N, int d, int64_t n_table, int device,
                              void* stream) {
  return launch(q, codes, ids, out, B, N, d, n_table, device, static_cast<cudaStream_t>(stream));
}
