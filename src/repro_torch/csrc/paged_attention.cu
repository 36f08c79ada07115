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
// it (B = 8, context 2048: 33.5 MB, 10 us at 3.35 TB/s).  Reaching that
// rate takes enough blocks on the 132 SMs, enough bytes in flight in each,
// and few enough instructions per byte: on the CUDA cores each bf16
// element costs a widening besides its FMAs, and a kernel doing that
// (measured on an H100) issues instructions for longer than HBM needs.
//
// Design.  Split the context (as flash-decoding does): one block per (KV
// head, sequence, run of split_tokens tokens), split_tokens chosen by the
// wrapper for at least four waves of blocks, each block holding the whole
// query group of its KV head so that each K/V byte leaves device memory
// once.  A block whose run starts past its sequence's context exits at
// once.  Inside a block, chunks of tokens stream through a ring of three
// stages of shared memory in the pages' own dtype, by 16-byte cp.async with
// one barrier per chunk; page ids are read from the block table by the
// block itself; tokens past the context are staged as zeros.  Each warp
// takes its own tokens of a chunk and keeps its own online-softmax state for
// every head of the group, so no barrier separates scoring, softmax and
// P V; the warps' states are merged once at the end through shared memory.
//   bf16 pages: 4 warps of 16 tokens a chunk of 64, on the tensor cores with
//   mma.sync m16n8k16 (rows are the group's heads, padded to 16): S = Q K^T
//   from K read by ldmatrix, products of bf16 values exact and summed in
//   fp32; O += P V with V read by ldmatrix.trans and P split into
//   hi = bf16(p) and lo = bf16(p - hi), each multiplied into the same fp32
//   accumulator (a single bf16 P would miss one bf16 ulp of the plain
//   version, as in flash_attention.cu).  At Dh 128 a warp issues ~100
//   instructions for 16 tokens (16 ldmatrix, 48 mma, the softmax) where
//   the CUDA cores took ~2 000 (measured on an H100: 172 us at B = 32 x
//   4096, 47 % of HBM, for any split; 118 us, 66 %, with mma.sync).
//   fp32 pages: IEEE fp32 on the CUDA cores (the fp32 bar rules out TF32);
//   8 warps of 4 tokens a chunk of 32; lane (head hh, part p) holds the
//   query and accumulator of head hh on the interleaved 16-byte units p,
//   p + parts, ... of the head dim (a compile-time width), so a score is
//   Dh / parts FMAs and log2(parts) shuffles.
// A block holds at most 32 heads and 4096 head-dim elements of accumulators
// (group * Dh): a larger group (granite-20b's 48 query heads over one KV
// head of Dh 128) is split into equal chunks of heads, one block each, and
// each chunk's block reads its KV head's pages again (right, no faster).
// With one split the block writes the output; otherwise it writes (m, l,
// acc) in fp32 to scratch the wrapper allocates and a second small kernel,
// launched by the same C call, combines the splits with the usual rescale.
// Softmax arithmetic is fp32 (exp2 of log2-scaled scores).  Masked tokens
// get probability 0, so a sequence with no token gives 0 / max(0, 1e-30) =
// 0, and a split that saw no token adds exactly 0.  A page id outside
// [0, n_pages) is staged as NaN, which reaches every output of that
// (sequence, KV head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kStages = 3;                  // ring of chunks in shared memory
constexpr int kMaxGroupElems = 4096;        // heads of a block * head_dim
constexpr int kMaxGroupHeads = 32;          // heads of a block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kNanBits = 0x7fc07fc0u;  // NaN as one fp32 and as two bf16

// KVH counts (KV head, head chunk) pairs, the blocks of a sequence's run:
// a KV head's query heads are split over hsplit blocks of H / KVH heads
// each, which read the pages' KV head g / hsplit of page_kvh.  Everything
// but the page reads treats a pair as a KV head of its own.
struct Shape {
  int H, KVH, page, max_pages, split_tokens, n_split;
  int64_t n_pages;
  float scale2;  // scale * log2(e)
  int hsplit, page_kvh;
};

// Issue the copies of tokens [c0, c0 + CHUNK) of the pages' KV head g into
// ks / vs (rows of RS elements): tokens at or past t_end become zeros, a bad
// page id NaN.
template <typename T, int DH, int RS, int CHUNK, int NT>
__device__ __forceinline__ void stage_chunk(T* ks, T* vs, const T* __restrict__ k_pages,
                                            const T* __restrict__ v_pages,
                                            const int32_t* __restrict__ table, const Shape& s,
                                            int g, int c0, int t_end) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPT = DH / VEC;  // 16-byte vectors a token row
  for (int idx = threadIdx.x; idx < CHUNK * VPT; idx += NT) {
    const int t = idx / VPT, d0 = (idx - t * VPT) * VEC;
    const int pos = c0 + t;
    T* kd = ks + t * RS + d0;
    T* vd = vs + t * RS + d0;
    const int lp = pos / s.page;
    const int pid = pos < t_end ? table[lp] : 0;
    if (pos < t_end && pid >= 0 && pid < s.n_pages) {
      const int64_t off =
          ((static_cast<int64_t>(pid) * s.page + (pos - lp * s.page)) * s.page_kvh + g) * DH + d0;
      cp_async16(kd, k_pages + off);
      cp_async16(vd, v_pages + off);
    } else {
      const uint32_t w = pos < t_end ? kNanBits : 0u;
      *reinterpret_cast<uint4*>(kd) = *reinterpret_cast<uint4*>(vd) = make_uint4(w, w, w, w);
    }
  }
}

// Merge NW warps' states, red[w] = (m, l) per head then acc (G, DH), and
// write the output (one split) or the split's partial state.
template <typename T, int DH, int NW, int NT>
__device__ __forceinline__ void merge_store(const float* red, const Shape& s, int b, int g,
                                            int split, T* __restrict__ out,
                                            float* __restrict__ part) {
  const int G = s.H / s.KVH;
  const int per_warp = G * (DH + 2);
  const int64_t row = (static_cast<int64_t>(b) * s.KVH + g) * s.n_split + split;
  for (int idx = threadIdx.x; idx < G * DH; idx += NT) {
    const int hd = idx / DH;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, red[w * per_warp + 2 * hd]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(red[w * per_warp + 2 * hd] - m);
      l = fmaf(red[w * per_warp + 2 * hd + 1], f, l);
      a = fmaf(red[w * per_warp + 2 * G + idx], f, a);
    }
    if (s.n_split == 1) {
      from_f32(a / fmaxf(l, 1e-30f), out + (static_cast<int64_t>(b) * s.H + g * G) * DH + idx);
    } else {
      part[row * G * DH + idx] = a;
      if (idx % DH == 0) {
        float* ml = part + static_cast<int64_t>(gridDim.y) * s.KVH * s.n_split * G * DH;
        ml[(row * G + hd) * 2] = m;
        ml[(row * G + hd) * 2 + 1] = l;
      }
    }
  }
}

// The block's token run; false (after writing zeros when the run is the
// whole, empty context) when it holds no token.
template <typename T, int DH, int NT>
__device__ __forceinline__ bool block_run(const int32_t* __restrict__ context_lens,
                                          const Shape& s, T* __restrict__ out, int& t_begin,
                                          int& t_end) {
  const int g = blockIdx.x, b = blockIdx.y, G = s.H / s.KVH;
  const int ctx = max(0, min(context_lens[b], s.max_pages * s.page));
  t_begin = blockIdx.z * s.split_tokens;
  t_end = min(ctx, t_begin + s.split_tokens);
  if (t_begin < ctx) return true;
  if (s.n_split == 1)  // no token at all: zeros (the combine reads only runs with tokens)
    for (int idx = threadIdx.x; idx < G * DH; idx += NT)
      from_f32(0.f, out + (static_cast<int64_t>(b) * s.H + g * G) * DH + idx);
  return false;
}

// ------------------------------------------------------------ bf16: mma.sync

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaChunk = 16 * kMmaWarps;  // 16 tokens a warp

// MT m-tiles of 16 heads; rows of the ring padded by 16 bytes so that the 8
// rows an ldmatrix reads fall in distinct banks
template <int DH, int MT>
__global__ void __launch_bounds__(kMmaThreads) paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ context_lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, Shape s) {
  using T = __nv_bfloat16;
  constexpr int RS = DH + 8;
  constexpr int NJ = DH / 8;  // n-tiles of the output
  const int g = blockIdx.x, b = blockIdx.y;
  const int G = s.H / s.KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, quad = lane % 4;
  int t_begin, t_end;
  if (!block_run<T, DH, kMmaThreads>(context_lens, s, out, t_begin, t_end)) return;
  const int n_chunks = (t_end - t_begin + kMmaChunk - 1) / kMmaChunk;
  const int32_t* table = block_tables + static_cast<int64_t>(b) * s.max_pages;

  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // stage st: K at st * 2 * kMmaChunk * RS, V after it
  auto stage = [&](int c) {
    T* ks = ring + (c % kStages) * 2 * kMmaChunk * RS;
    stage_chunk<T, DH, RS, kMmaChunk, kMmaThreads>(ks, ks + kMmaChunk * RS, k_pages, v_pages,
                                                   table, s, g / s.hsplit,
                                                   t_begin + c * kMmaChunk, t_end);
  };

  // Q as A fragments: rows = heads of the group (zeros past G), k = head dim
  uint32_t qa[MT][DH / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hd = mt * 16 + gr + 8 * r;
      const T* qh = q + (static_cast<int64_t>(b) * s.H + g * G + hd) * DH;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          qa[mt][kk][r + 2 * c] =
              hd < G ? *reinterpret_cast<const uint32_t*>(qh + kk * 16 + 8 * c + 2 * quad) : 0u;
        }
      }
    }
  }
  float o[MT][NJ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  float m_r[MT][2], l_r[MT][2];  // rows gr and gr + 8 of each m-tile; l summed per lane
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_r[mt][r] = kNegInf;
      l_r[mt][r] = 0.f;
    }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage
    if (c + kStages - 1 < n_chunks) stage(c + kStages - 1);
    cp_async_commit();
    const int t0 = t_begin + c * kMmaChunk + warp * 16;  // this warp's first token
    if (t0 >= t_end) continue;
    const T* ks = ring + (c % kStages) * 2 * kMmaChunk * RS + warp * 16 * RS;
    const T* vs = ks + kMmaChunk * RS;

    // S = Q K^T: (16 heads) x (16 tokens) per m-tile, two n-tiles of 8 tokens
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][n][e] = 0.f;
    const int mi = lane / 8, mr = lane % 8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t kb[4];  // (tokens 0-7 | 8-15) x (dims 0-7 | 8-15) of this k step
      ldmatrix_x4(kb, ks + (mr + 8 * (mi / 2)) * RS + kk * 16 + 8 * (mi % 2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(sc[mt][0], qa[mt][kk], kb[0], kb[1]);
        mma_bf16_16816(sc[mt][1], qa[mt][kk], kb[2], kb[3]);
      }
    }

    // online softmax of rows gr, gr + 8; sc[mt][n][2r + e] is token t0 + 8n + 2 quad + e
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = t0 + 8 * n + 2 * quad + e < t_end;
            const float x = ok ? sc[mt][n][2 * r + e] * s.scale2 : -INFINITY;
            sc[mt][n][2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[mt][r], mx);
        const float alpha = fast_exp2(m_r[mt][r] - m_new);
        m_r[mt][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float p0 = fast_exp2(sc[mt][n][2 * r] - m_new);
          const float p1 = fast_exp2(sc[mt][n][2 * r + 1] - m_new);
          sum += p0 + p1;
          // A fragment of P: a[r + 2n] = (row gr + 8r, tokens 8n + 2 quad + {0, 1})
          split_bf16(p0, p1, ph[mt][r + 2 * n], pl[mt][r + 2 * n]);
        }
        l_r[mt][r] = l_r[mt][r] * alpha + sum;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          o[mt][j][2 * r] *= alpha;
          o[mt][j][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P_hi V + P_lo V, 16 dims (two n-tiles) a step
#pragma unroll
    for (int dj = 0; dj < DH / 16; ++dj) {
      uint32_t vb[4];  // (tokens 0-7 | 8-15) x (dims 0-7 | 8-15), transposed
      ldmatrix_x4_trans(vb, vs + (mr + 8 * (mi % 2)) * RS + dj * 16 + 8 * (mi / 2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(o[mt][2 * dj], ph[mt], vb[0], vb[1]);
        mma_bf16_16816(o[mt][2 * dj], pl[mt], vb[0], vb[1]);
        mma_bf16_16816(o[mt][2 * dj + 1], ph[mt], vb[2], vb[3]);
        mma_bf16_16816(o[mt][2 * dj + 1], pl[mt], vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' states

  float* red = reinterpret_cast<float*>(smem4);
  float* mine = red + warp * G * (DH + 2);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hd = mt * 16 + gr + 8 * r;
      float l = l_r[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (hd < G) {
        if (quad == 0) {
          mine[2 * hd] = m_r[mt][r];
          mine[2 * hd + 1] = l;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mine[2 * G + hd * DH + 8 * j + 2 * quad] = o[mt][j][2 * r];
          mine[2 * G + hd * DH + 8 * j + 2 * quad + 1] = o[mt][j][2 * r + 1];
        }
      }
    }
  }
  __syncthreads();
  merge_store<T, DH, kMmaWarps, kMmaThreads>(red, s, b, g, blockIdx.z, out, part);
}

// ------------------------------------------------------------ fp32: CUDA cores

constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Chunk = 32;
constexpr int kTokPerWarp = kF32Chunk / kF32Warps;

// lanes (hh, p), hh < HPW heads of the group, p < 32 / HPW parts of the head
// dim; each lane holds E = DH / parts elements, as units of U elements (so
// 32 / HPW <= DH: at Dh 16 a warp holds at least two heads)
template <int DH, int HPW>
struct Lanes {
  static_assert(32 / HPW <= DH, "a lane holds at least one element of its head");
  static constexpr int PARTS = 32 / HPW;
  static constexpr int E = DH / PARTS;
  static constexpr int U = E < 4 ? E : 4;
  static constexpr int NU = E / U;
  // head-dim index of element e of unit i of part p
  static __device__ __forceinline__ int dim(int p, int i, int e) { return (p + PARTS * i) * U + e; }
};

// U floats at p (U * 4 bytes, aligned to that)
template <int U>
__device__ __forceinline__ void load_units(const float* p, float* f) {
  if constexpr (U == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < U; ++e) f[e] = p[e];
  }
}

template <int DH, int HPW>
__global__ void __launch_bounds__(kF32Threads, Lanes<DH, HPW>::E <= 32 ? 2 : 1)
    paged_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                               const float* __restrict__ v_pages,
                               const int32_t* __restrict__ block_tables,
                               const int32_t* __restrict__ context_lens, float* __restrict__ out,
                               float* __restrict__ part, Shape s) {
  using L = Lanes<DH, HPW>;
  const int g = blockIdx.x, b = blockIdx.y;
  const int G = s.H / s.KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hh = lane / L::PARTS, p = lane % L::PARTS;
  int t_begin, t_end;
  if (!block_run<float, DH, kF32Threads>(context_lens, s, out, t_begin, t_end)) return;
  const int n_chunks = (t_end - t_begin + kF32Chunk - 1) / kF32Chunk;
  const int32_t* table = block_tables + static_cast<int64_t>(b) * s.max_pages;

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // stage st: K at st * 2 * kF32Chunk * DH, V after
  auto stage = [&](int c) {
    float* ks = ring + (c % kStages) * 2 * kF32Chunk * DH;
    stage_chunk<float, DH, DH, kF32Chunk, kF32Threads>(ks, ks + kF32Chunk * DH, k_pages, v_pages,
                                                       table, s, g / s.hsplit,
                                                       t_begin + c * kF32Chunk, t_end);
  };

  // this lane's query (zeros for a lane past the group) and state
  float qr[L::NU][L::U], acc[L::NU][L::U];
#pragma unroll
  for (int i = 0; i < L::NU; ++i) {
    if (hh < G) {
      load_units<L::U>(q + (static_cast<int64_t>(b) * s.H + g * G + hh) * DH + L::dim(p, i, 0),
                       qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < L::U; ++e) qr[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < L::U; ++e) acc[i][e] = 0.f;
  }
  float m_r = kNegInf, l_r = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage
    if (c + kStages - 1 < n_chunks) stage(c + kStages - 1);
    cp_async_commit();

    const float* ks = ring + (c % kStages) * 2 * kF32Chunk * DH;
    const float* vs = ks + kF32Chunk * DH;
    const int c0 = t_begin + c * kF32Chunk;
    float sc[kTokPerWarp];
#pragma unroll
    for (int j = 0; j < kTokPerWarp; ++j) {
      const int t = warp * kTokPerWarp + j;
      float dot = 0.f;
      if (c0 + t < t_end) {
#pragma unroll
        for (int i = 0; i < L::NU; ++i) {
          float kf[L::U];
          load_units<L::U>(ks + t * DH + L::dim(p, i, 0), kf);
#pragma unroll
          for (int e = 0; e < L::U; ++e) dot = fmaf(qr[i][e], kf[e], dot);
        }
      }
      sc[j] = dot;
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kTokPerWarp; ++j) {
#pragma unroll
      for (int o = L::PARTS / 2; o > 0; o >>= 1) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], o);
      const bool valid = c0 + warp * kTokPerWarp + j < t_end;
      sc[j] = valid ? sc[j] * s.scale2 : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m_r, mx);
    const float alpha = exp2f(m_r - m_new);
    m_r = m_new;
    l_r *= alpha;
#pragma unroll
    for (int i = 0; i < L::NU; ++i)
#pragma unroll
      for (int e = 0; e < L::U; ++e) acc[i][e] *= alpha;
#pragma unroll
    for (int j = 0; j < kTokPerWarp; ++j) {
      const int t = warp * kTokPerWarp + j;
      if (c0 + t < t_end) {
        const float pj = exp2f(sc[j] - m_new);
        l_r += pj;
#pragma unroll
        for (int i = 0; i < L::NU; ++i) {
          float vf[L::U];
          load_units<L::U>(vs + t * DH + L::dim(p, i, 0), vf);
#pragma unroll
          for (int e = 0; e < L::U; ++e) acc[i][e] = fmaf(pj, vf[e], acc[i][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' states

  float* red = ring;
  float* mine = red + warp * G * (DH + 2);
  if (hh < G) {
    if (p == 0) {
      mine[2 * hh] = m_r;
      mine[2 * hh + 1] = l_r;
    }
#pragma unroll
    for (int i = 0; i < L::NU; ++i)
#pragma unroll
      for (int e = 0; e < L::U; ++e) mine[2 * G + hh * DH + L::dim(p, i, e)] = acc[i][e];
  }
  __syncthreads();
  merge_store<float, DH, kF32Warps, kF32Threads>(red, s, b, g, blockIdx.z, out, part);
}

// out[b, g's heads] from the splits that hold tokens:
// sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30), M = max_s m_s,
// one block per (KV head, sequence, head of the group), one thread a dim
template <typename T>
__global__ void __launch_bounds__(256) paged_combine_kernel(
    const float* __restrict__ part, const int32_t* __restrict__ context_lens,
    T* __restrict__ out, Shape s) {
  const int g = blockIdx.x, b = blockIdx.y, hd = blockIdx.z, d = threadIdx.x, Dh = blockDim.x;
  const int G = s.H / s.KVH;
  const int ctx = max(0, min(context_lens[b], s.max_pages * s.page));
  const int n_valid = (ctx + s.split_tokens - 1) / s.split_tokens;
  const int64_t row0 = (static_cast<int64_t>(b) * s.KVH + g) * s.n_split;
  const float* ml = part + static_cast<int64_t>(gridDim.y) * s.KVH * s.n_split * G * Dh;
  float m = kNegInf;
  for (int sp = 0; sp < n_valid; ++sp) m = fmaxf(m, ml[((row0 + sp) * G + hd) * 2]);
  float l = 0.f, a = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < n_valid; ++sp) {
    const float f = exp2f(ml[((row0 + sp) * G + hd) * 2] - m);
    l = fmaf(ml[((row0 + sp) * G + hd) * 2 + 1], f, l);
    a = fmaf(part[((row0 + sp) * G + hd) * Dh + d], f, a);
  }
  from_f32(a / fmaxf(l, 1e-30f), out + (static_cast<int64_t>(b) * s.H + g * G + hd) * Dh + d);
}

// Launch a split kernel with `smem` bytes of dynamic shared memory, then,
// with more than one split, the combine.
template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const T* q, const T* k,
                   const T* v, const int32_t* bt, const int32_t* cl, T* out, float* part, int B,
                   const Shape& s, int Dh, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(s.KVH, B, s.n_split), threads, smem, stream>>>(q, k, v, bt, cl, out, part, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || s.n_split == 1) return err;
  paged_combine_kernel<T><<<dim3(s.KVH, B, s.H / s.KVH), Dh, 0, stream>>>(part, cl, out, s);
  return cudaGetLastError();
}

size_t merge_bytes(int G, int Dh, int warps) {
  return static_cast<size_t>(warps) * G * (Dh + 2) * sizeof(float);
}

template <int DH>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const int32_t* bt, const int32_t* cl, __nv_bfloat16* out, float* part,
                        int B, const Shape& s, cudaStream_t st) {
  const int G = s.H / s.KVH;
  const size_t ring = static_cast<size_t>(kStages) * 2 * kMmaChunk * (DH + 8) * 2;
  const size_t smem = ring > merge_bytes(G, DH, kMmaWarps) ? ring : merge_bytes(G, DH, kMmaWarps);
  if (G <= 16)
    return launch(paged_attention_mma_kernel<DH, 1>, kMmaThreads, smem, q, k, v, bt, cl, out,
                  part, B, s, DH, st);
  if constexpr (DH <= 128) {
    if (G <= 32)
      return launch(paged_attention_mma_kernel<DH, 2>, kMmaThreads, smem, q, k, v, bt, cl, out,
                    part, B, s, DH, st);
  }
  return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const int32_t* bt,
                       const int32_t* cl, float* out, float* part, int B, const Shape& s,
                       cudaStream_t st) {
  const int G = s.H / s.KVH;
  const size_t ring = static_cast<size_t>(kStages) * 2 * kF32Chunk * DH * 4;
  const size_t smem = ring > merge_bytes(G, DH, kF32Warps) ? ring : merge_bytes(G, DH, kF32Warps);
  // the smallest power of two >= G heads per warp, as many parts as fit
#define PAGED_F32(HPW)                                                                          \
  if constexpr (32 / HPW <= DH) {                                                               \
    if (G <= HPW)                                                                               \
      return launch(paged_attention_f32_kernel<DH, HPW>, kF32Threads, smem, q, k, v, bt, cl,    \
                    out, part, B, s, DH, st);                                                   \
  }
  PAGED_F32(1) PAGED_F32(2) PAGED_F32(4) PAGED_F32(8) PAGED_F32(16)
#undef PAGED_F32
  if constexpr (DH <= 128) {
    if (G <= 32)
      return launch(paged_attention_f32_kernel<DH, 32>, kF32Threads, smem, q, k, v, bt, cl, out,
                    part, B, s, DH, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename Launch>
int entry(const Launch (&by_dh)[5], const void* q, const void* k_pages, const void* v_pages,
          const int32_t* block_tables, const int32_t* context_lens, void* out, float* part, int B,
          int H, int KVH, int head_chunks, int Dh, int page, int max_pages, int64_t n_pages,
          int split_tokens, int n_split, float scale, int device, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(k_pages) |
                          reinterpret_cast<uintptr_t>(v_pages) | reinterpret_cast<uintptr_t>(q);
  const int64_t blocks = static_cast<int64_t>(KVH) * head_chunks;  // blocks of a run
  if (B <= 0 || B > 65535 || H <= 0 || KVH <= 0 || head_chunks <= 0 || blocks > H ||
      H % blocks != 0 || H / blocks * Dh > kMaxGroupElems || H / blocks > kMaxGroupHeads ||
      page <= 0 || max_pages <= 0 || split_tokens <= 0 ||
      split_tokens % kMmaChunk != 0 || split_tokens % page != 0 || n_split <= 0 ||
      n_split > 65535 ||
      static_cast<int64_t>(n_split) * split_tokens < static_cast<int64_t>(max_pages) * page ||
      (n_split > 1 && part == nullptr) || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int which =
      Dh == 16 ? 0 : Dh == 32 ? 1 : Dh == 64 ? 2 : Dh == 128 ? 3 : Dh == 256 ? 4 : -1;
  if (which < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s{H,     static_cast<int>(blocks), page, max_pages, split_tokens, n_split, n_pages,
                scale * kLog2e, head_chunks, KVH};
  err = by_dh[which](static_cast<const T*>(q), static_cast<const T*>(k_pages),
                     static_cast<const T*>(v_pages), block_tables, context_lens,
                     static_cast<T*>(out), part, B, s, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

using LaunchF32 = cudaError_t (*)(const float*, const float*, const float*, const int32_t*,
                                  const int32_t*, float*, float*, int, const Shape&,
                                  cudaStream_t);
using LaunchBf16 = cudaError_t (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                                   const __nv_bfloat16*, const int32_t*, const int32_t*,
                                   __nv_bfloat16*, float*, int, const Shape&, cudaStream_t);
constexpr LaunchF32 kF32[5] = {launch_f32<16>, launch_f32<32>, launch_f32<64>, launch_f32<128>,
                               launch_f32<256>};
constexpr LaunchBf16 kBf16[5] = {launch_bf16<16>, launch_bf16<32>, launch_bf16<64>,
                                 launch_bf16<128>, launch_bf16<256>};

}  // namespace

// Plain C entries for ctypes.  q and out are (B, H, Dh), k_pages and v_pages
// (n_pages, page, KVH, Dh), all row-major in one dtype (fp32 or bf16), 16-byte
// aligned; block_tables (B, max_pages) and context_lens (B,) int32.  Dh is
// 16, 32, 64, 128 or 256; each KV head's H / KVH query heads are split over
// head_chunks blocks of G = H / (KVH * head_chunks) heads, G an integer with
// G * Dh <= 4096 and G <= 32.  Token t of a sequence belongs to split
// t / split_tokens (split_tokens a multiple of 64 and of page, n_split *
// split_tokens >= max_pages * page); with n_split > 1, part is fp32 scratch
// of B * H * n_split * (Dh + 2) floats.  Launches one kernel, or two with
// n_split > 1.  Returns the launches' cudaError_t; 0 is success.
extern "C" int paged_attention_f32(const void* q, const void* k_pages, const void* v_pages,
                                   const int32_t* block_tables, const int32_t* context_lens,
                                   void* out, float* part, int B, int H, int KVH,
                                   int head_chunks, int Dh, int page, int max_pages,
                                   int64_t n_pages, int split_tokens, int n_split, float scale,
                                   int device, void* stream) {
  return entry<float>(kF32, q, k_pages, v_pages, block_tables, context_lens, out, part, B, H, KVH,
                      head_chunks, Dh, page, max_pages, n_pages, split_tokens, n_split, scale,
                      device, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                    const int32_t* block_tables, const int32_t* context_lens,
                                    void* out, float* part, int B, int H, int KVH,
                                    int head_chunks, int Dh, int page, int max_pages,
                                    int64_t n_pages, int split_tokens, int n_split, float scale,
                                    int device, void* stream) {
  return entry<__nv_bfloat16>(kBf16, q, k_pages, v_pages, block_tables, context_lens, out, part,
                              B, H, KVH, head_chunks, Dh, page, max_pages, n_pages, split_tokens,
                              n_split, scale, device, stream);
}
