// paged_attention: decode attention through a KV block table.
// out[b, h] = softmax(q[b, h] . K_b^T * scale) V_b over the first
// context_lens[b] tokens of sequence b, whose token t lives in page
// block_tables[b, t / page] at row t % page, KV head h / (H / KVH).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/kernel.py
// (_paged_kernel, driven by paged_attention_pallas), whose grid
// (B, H, max_pages) walks every page slot once per query head, the page id
// read from the scalar-prefetched block table.
//
// What bounds it on the H100.  A decode step reads every valid K/V byte once
// and does 4 flops per head per K/V element it reads for its group: at
// Yi-6B widths (group 8, Dh 128, bf16) that is 8 flops a byte against the
// fp32 ridge of 20 and the bf16 ridge of 295, so device-memory bytes bound
// it (B = 8, context 2048: 33.5 MB, 10 us at 3.35 TB/s).
//
// Design.  The TPU grid would read each K/V page once per query head (8x at
// Yi's group of 8).  Here one block owns one (sequence, KV head) and all
// H/KVH query heads of its group, so each K/V byte leaves device memory
// once.  The block walks only the ceil(context_len / 32) chunks of 32
// tokens the sequence has, reading the page id of each token from the block
// table itself, with 16-byte loads; the next chunk's loads are issued into
// registers before the current chunk is computed, so they overlap it.  A
// chunk is converted to fp32 in shared memory; scores are one (head, token)
// dot product per thread; the online softmax is one warp per head; the
// (head, dim) accumulators live in registers.  All arithmetic is IEEE fp32.
// Masked tokens get probability 0 (not exp(-1e30 - m)), so a sequence with
// no token gives 0 / max(0, 1e-30) = 0.  The known cost of this simple
// shape: only B * KVH blocks (32 at B = 8) for 132 SMs, and one chunk in
// flight per block; splitting the page range across blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;           // tokens per step, one per lane in the softmax
constexpr int kMaxHeadDim = 256;
constexpr int kMaxGroup = 32;        // query heads per KV head
constexpr int kMaxGroupElems = 4096; // group * head_dim
constexpr int kMaxAcc = kMaxGroupElems / kThreads;
constexpr int kMaxHeadsPerWarp = kMaxGroup / kWarps;
// 16-byte vectors of K (and of V) per thread per chunk: fp32 at Dh = 256
constexpr int kMaxLoads = kChunk * kMaxHeadDim * 4 / 16 / kThreads;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kNanBits = 0x7fc07fc0u;  // NaN as one fp32 and as two bf16

struct Shape {
  int H, KVH, Dh, page, max_pages;
  int64_t n_pages;
  float scale;
};

// Issue the loads of chunk c's K and V vectors into registers.
template <typename T>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int32_t* __restrict__ table, const Shape& s, int g, int ctx, int c,
    uint4 (&kr)[kMaxLoads], uint4 (&vr)[kMaxLoads]) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_per_tok = s.Dh / VEC;
  const int nvec = kChunk * vec_per_tok;
#pragma unroll
  for (int i = 0; i < kMaxLoads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nvec) {
      const int t = idx / vec_per_tok, part = idx - t * vec_per_tok;
      const int pos = c * kChunk + t;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (pos < ctx) {
        const int lp = pos / s.page;
        const int pid = table[lp];
        if (pid >= 0 && pid < s.n_pages) {
          const int64_t off =
              ((static_cast<int64_t>(pid) * s.page + (pos - lp * s.page)) * s.KVH + g) * s.Dh +
              part * VEC;
          kv = *reinterpret_cast<const uint4*>(k_pages + off);
          vv = *reinterpret_cast<const uint4*>(v_pages + off);
        } else {
          kv = vv = make_uint4(kNanBits, kNanBits, kNanBits, kNanBits);
        }
      }
      kr[i] = kv;
      vr[i] = vv;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int32_t* __restrict__ block_tables, const int32_t* __restrict__ context_lens,
    T* __restrict__ out, Shape s) {
  constexpr int VEC = 16 / sizeof(T);
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = s.H / s.KVH, Dh = s.Dh, kstride = Dh + 1;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (G, Dh)
  float* ks = qs + G * Dh;                      // (kChunk, Dh + 1), padded rows
  float* vs = ks + kChunk * kstride;            // (kChunk, Dh)
  float* ps = vs + kChunk * Dh;                 // (G, kChunk) scores, then probabilities
  float* hs = ps + G * kChunk;                  // (G,) alpha per chunk, l at the end

  const int64_t q_off = (static_cast<int64_t>(b) * s.H + static_cast<int64_t>(g) * G) * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) qs[i] = to_f32(q[q_off + i]);

  const int ctx = max(0, min(context_lens[b], s.max_pages * s.page));
  const int n_chunks = (ctx + kChunk - 1) / kChunk;
  const int32_t* table = block_tables + static_cast<int64_t>(b) * s.max_pages;
  const int vec_per_tok = Dh / VEC;
  const int nvec = kChunk * vec_per_tok;

  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  float m_r[kMaxHeadsPerWarp], l_r[kMaxHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    m_r[j] = kNegInf;
    l_r[j] = 0.f;
  }

  uint4 kr[kMaxLoads], vr[kMaxLoads];
  if (n_chunks > 0) load_chunk<T>(k_pages, v_pages, table, s, g, ctx, 0, kr, vr);

  for (int c = 0; c < n_chunks; ++c) {
    // registers -> fp32 shared memory
#pragma unroll
    for (int i = 0; i < kMaxLoads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < nvec) {
        const int t = idx / vec_per_tok, d0 = (idx - t * vec_per_tok) * VEC;
        float fk[VEC], fv[VEC];
        unpack(kr[i], fk, T());
        unpack(vr[i], fv, T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ks[t * kstride + d0 + e] = fk[e];
          vs[t * Dh + d0 + e] = fv[e];
        }
      }
    }
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk<T>(k_pages, v_pages, table, s, g, ctx, c + 1, kr, vr);

    // scores: one (head, token) pair per thread; lanes run over tokens
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int h = i / kChunk, t = i - h * kChunk;
      float sc = kNegInf;
      if (c * kChunk + t < ctx) {
        const float* qh = qs + h * Dh;
        const float* kt = ks + t * kstride;
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot = fmaf(qh[d], kt[d], dot);
        sc = dot * s.scale;
      }
      ps[i] = sc;
    }
    __syncthreads();

    // online softmax: one warp per head, one lane per token
#pragma unroll
    for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
      const int h = warp + j * kWarps;
      if (h < G) {
        const float sc = ps[h * kChunk + lane];
        const bool valid = c * kChunk + lane < ctx;
        float mx = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_r[j], mx);
        const float p = valid ? expf(sc - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_r[j] - m_new);
        l_r[j] = alpha * l_r[j] + sum;
        m_r[j] = m_new;
        ps[h * kChunk + lane] = p;
        if (lane == 0) hs[h] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V, one (head, dim) element per register slot
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int e = tid + j * kThreads;
      if (e < G * Dh) {
        const int h = e / Dh, d = e - h * Dh;
        const float* ph = ps + h * kChunk;
        float a = acc[j] * hs[h];
#pragma unroll 8
        for (int t = 0; t < kChunk; ++t) a = fmaf(ph[t], vs[t * Dh + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    const int h = warp + j * kWarps;
    if (h < G && lane == 0) hs[h] = l_r[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int e = tid + j * kThreads;
    if (e < G * Dh) from_f32(acc[j] / fmaxf(hs[e / Dh], 1e-30f), out + q_off + e);
  }
}

template <typename T>
cudaError_t launch(const T* q, const T* k_pages, const T* v_pages, const int32_t* block_tables,
                   const int32_t* context_lens, T* out, int B, const Shape& s,
                   cudaStream_t stream) {
  const int G = s.H / s.KVH;
  const size_t smem =
      (static_cast<size_t>(G) * s.Dh + static_cast<size_t>(kChunk) * (2 * s.Dh + 1) +
       static_cast<size_t>(G) * kChunk + G) * sizeof(float);
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(s.KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k_pages, v_pages, block_tables, context_lens,
                                           out, s);
  return cudaGetLastError();
}

template <typename T>
int entry(const void* q, const void* k_pages, const void* v_pages, const int32_t* block_tables,
          const int32_t* context_lens, void* out, int B, int H, int KVH, int Dh, int page,
          int max_pages, int64_t n_pages, float scale, int device, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Dh <= 0 || Dh % VEC != 0 ||
      Dh > kMaxHeadDim || H / KVH > kMaxGroup || H / KVH * Dh > kMaxGroupElems || page <= 0 ||
      max_pages <= 0 || reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s{H, KVH, Dh, page, max_pages, n_pages, scale};
  err = launch<T>(static_cast<const T*>(q), static_cast<const T*>(k_pages),
                  static_cast<const T*>(v_pages), block_tables, context_lens,
                  static_cast<T*>(out), B, s, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

// Plain C entries for ctypes.  q and out are (B, H, Dh), k_pages and v_pages
// (n_pages, page, KVH, Dh), all row-major in one dtype (fp32 or bf16);
// block_tables (B, max_pages) and context_lens (B,) int32.  Dh must be a
// multiple of 16 bytes and at most 256, H a multiple of KVH with
// H / KVH <= 32 and H / KVH * Dh <= 4096, the page pointers 16-byte
// aligned.  Returns the launch's cudaError_t; 0 is success.
extern "C" int paged_attention_f32(const void* q, const void* k_pages, const void* v_pages,
                                   const int32_t* block_tables, const int32_t* context_lens,
                                   void* out, int B, int H, int KVH, int Dh, int page,
                                   int max_pages, int64_t n_pages, float scale, int device,
                                   void* stream) {
  return entry<float>(q, k_pages, v_pages, block_tables, context_lens, out, B, H, KVH, Dh, page,
                      max_pages, n_pages, scale, device, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                    const int32_t* block_tables, const int32_t* context_lens,
                                    void* out, int B, int H, int KVH, int Dh, int page,
                                    int max_pages, int64_t n_pages, float scale, int device,
                                    void* stream) {
  return entry<__nv_bfloat16>(q, k_pages, v_pages, block_tables, context_lens, out, B, H, KVH,
                              Dh, page, max_pages, n_pages, scale, device, stream);
}
