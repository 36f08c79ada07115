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
// (35 us there) and the fp32 peak for fp32 inputs.  This first kernel does
// its products with fp32 FMA on the CUDA cores, so it can reach at most the
// 67 TFLOP/s fp32 peak, about 1/15 of the bf16 bound; wgmma is later work.
//
// Design.  One block per (query tile of 64 rows, head, sequence), with a
// loop over 64-key tiles in place of the TPU's sequential grid axis.  Key
// tiles that the causal mask or the window rule out for every row of the
// query tile are never loaded; ragged edges (rows past Sq, keys past Skv)
// are masked here, so nothing is padded in device memory.  Q, K and V tiles
// are converted to fp32 in shared memory (rows padded by one float so that
// the 16 threads reading 16 different rows hit 16 banks); 16 x 16 threads
// each hold a 4 x 4 block of scores (rows ty + 16i, keys tx + 16j) and the
// same 4 rows of the output accumulator, so the row max and sum are 16-lane
// shuffles and the rescale by alpha needs no shared memory.  IEEE fp32
// throughout.  A masked key gets probability 0, so a row that sees no key
// gives 0 / max(0, 1e-30) = 0.  Shared memory is 115 KB at Dh = 128 and
// 214 KB at Dh = 256, above the 48 KB static limit, so the launch raises
// the dynamic limit first and returns the error if the card refuses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

// rows [r0, r0 + 64) of a (rows, DH) matrix into fp32 shared memory with
// row stride `stride`; rows at or past `rows` become zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int stride,
                                          int r0, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DH / VEC;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, d0 = (idx - r * PER_ROW) * VEC;
    float f[VEC];
    if (r0 + r < rows) {
      unpack(*reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r0 + r) * DH + d0), f,
             T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * stride + d0 + e] = f[e];
  }
}

struct Shape {
  int H, KVH, Sq, Skv, causal, has_window, window;
  float scale;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Shape s) {
  constexpr int NJ = DH / 16;     // output columns per thread
  constexpr int QS = DH + 1;      // padded row stride of Q and K
  constexpr int PS = kBK + 1;     // padded row stride of P
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (kBQ, DH + 1)
  float* ks = qs + kBQ * QS;                    // (kBK, DH + 1)
  float* vs = ks + kBK * QS;                    // (kBK, DH)
  float* ps = vs + kBK * DH;                    // (kBQ, kBK + 1)

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (s.H / s.KVH);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = s.Skv - s.Sq;  // key position of query row 0
  const T* qb = q + (static_cast<int64_t>(b) * s.H + h) * s.Sq * DH;
  const T* kb = k + (static_cast<int64_t>(b) * s.KVH + kvh) * s.Skv * DH;
  const T* vb = v + (static_cast<int64_t>(b) * s.KVH + kvh) * s.Skv * DH;

  load_tile<T, DH>(qb, qs, QS, q0, s.Sq);

  // the keys some real row of this tile may see
  const int last_row = min(q0 + kBQ, s.Sq) - 1;
  int k_lo = 0, k_hi = s.Skv;
  if (s.causal) k_hi = min(k_hi, last_row + offset + 1);
  if (s.has_window) k_lo = max(k_lo, q0 + offset - s.window + 1);

  float m_r[4], l_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = k_lo / kBK; k_lo < k_hi && kt * kBK < k_hi; ++kt) {
    const int kbase = kt * kBK;
    __syncthreads();  // the previous tile's reads of ks, vs and ps are done
    load_tile<T, DH>(kb, ks, QS, kbase, s.Skv);
    load_tile<T, DH>(vb, vs, DH, kbase, s.Skv);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kbase + tx + 16 * j;
        ok[j] = kp < s.Skv && (!s.causal || kp <= qp) && (!s.has_window || kp > qp - s.window);
        sc[i][j] = ok[j] ? sc[i][j] * s.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads of a row are lanes with equal bits 4.. of the lane id
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = alpha * l_r[i] + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[kk * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = out + (static_cast<int64_t>(b) * s.H + h) * s.Sq * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < s.Sq) {
      const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        from_f32(acc[i][j] / l, ob + static_cast<int64_t>(row) * DH + tx + 16 * j);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int B, const Shape& s,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kBQ + kBK) * (DH + 1) + static_cast<size_t>(kBK) * DH +
       static_cast<size_t>(kBQ) * (kBK + 1)) * sizeof(float);
  auto kernel = flash_attention_kernel<T, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Sq + kBQ - 1) / kBQ, s.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, s);
  return cudaGetLastError();
}

template <typename T>
int entry(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH, int Sq,
          int Skv, int Dh, int causal, int has_window, int window, float scale, int device,
          void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 || B > 65535 ||
      H > 65535 || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s{H, KVH, Sq, Skv, causal, has_window, window, scale};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: err = launch<T, 32>(qt, kt, vt, ot, B, s, st); break;
    case 64: err = launch<T, 64>(qt, kt, vt, ot, B, s, st); break;
    case 128: err = launch<T, 128>(qt, kt, vt, ot, B, s, st); break;
    case 256: err = launch<T, 256>(qt, kt, vt, ot, B, s, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entries for ctypes.  q and out are (B, H, Sq, Dh), k and v
// (B, KVH, Skv, Dh), all row-major in one dtype (fp32 or bf16), 16-byte
// aligned; Dh is 32, 64, 128 or 256 and H a multiple of KVH.  causal and
// has_window are 0 or 1; window is used only when has_window is 1.
// Returns the launch's cudaError_t; 0 is success.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int H, int KVH, int Sq, int Skv, int Dh, int causal,
                                   int has_window, int window, float scale, int device,
                                   void* stream) {
  return entry<float>(q, k, v, out, B, H, KVH, Sq, Skv, Dh, causal, has_window, window, scale,
                      device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int KVH, int Sq, int Skv, int Dh, int causal,
                                    int has_window, int window, float scale, int device,
                                    void* stream) {
  return entry<__nv_bfloat16>(q, k, v, out, B, H, KVH, Sq, Skv, Dh, causal, has_window, window,
                              scale, device, stream);
}
