// scan_select: scan_search's stage-1 epilogue of one corpus chunk in one pass.
// From binary_ip's (B, L) fp32 sign product g of the chunk it forms the bf16
// level-1 estimate of every entry in registers,
//   est = qn^2 + nr^2 - ((2 qn) nr) clip(bf16(g / sqrt(d)) / ipb, -1, 1),
// with stage1_block's casts (each op in fp32, rounded to bf16 where PyTorch
// rounds it), and keeps each query row's C smallest estimates, merged with
// the running carry: it writes the new (B, C) carry of values and ids, and
// nothing of the (B, L) estimate.
//
// Inner product (scan_select_ip_kernel, the entry scan_select_ip_bf16): the
// same pass with the estimate of the negated inner product less the query's
// <q, c>, which orders nothing within a row,
//   est = -(cr + (qn nr) clip(bf16(g / sqrt(d)) / ipb, -1, 1)),
// from a per-row cr = bf16(<c, o - c>) in the table's slot of nr^2 and a
// query table of qn alone, one bf16 a query (kernels/scan_select/ref.py::
// estimate_ip).
// The two kernels differ in that last step alone, and carry their own names
// so that a device trace tells them apart.
//
// Order.  Candidates are ordered by the bf16 value, then by the global row
// id: what torch.argsort(stable=True) of [carry | chunk] gives, since every
// chunk id is above every carried id (the first carry is bf16(3e38) with
// ids 0).  -0 equals +0 and every NaN comes after every number.  An entry
// is one 64-bit word, key(value) << 48 | id << 16 | value bits, where key
// maps the bf16 bits to that order; ids are distinct, so the words order
// the candidates and the value bits ride along unchanged.
//
// Replaces no TPU kernel: the JAX package leaves the estimator to XLA and
// takes lax.top_k of each chunk.  The port's plain chain of the same
// function (kernels/scan_select/ref.py) is ~7 bf16 elementwise passes over
// the (B, L) matrix, a stable segmented sort of the whole chunk to keep C
// entries a row, and a second sort for the merge: at B = 4 096 and L =
// 32 768 ~7 ms a chunk, against ~0.16 ms to read g once at 3.35 TB/s.
//
// What bounds it.  Reading g: B L 4 bytes a chunk, 512 MiB at the
// benchmark's shape (0.16 ms at 3.35 TB/s).  The estimate is ~20
// instructions an entry on the CUDA cores, about as long again if issued
// serially: the design keeps both streams full at once.
//
// Design.  A block of 256 threads takes R query rows (2 when B >= 1 024 and
// C <= 128, else 1) over the whole chunk; a thread takes 4 consecutive
// columns a step (a 16-byte piece of g a row, and the columns' 8-byte table
// entries once for its R rows) and walks the chunk in steps of 1 024
// columns, the next step's pieces in flight by cp.async while it computes.
// A step's R x 4 estimates are straight-line code: the IEEE quotient of the
// chain is taken as a product with the column's fp32 reciprocal, exact in
// bf16 where fast_pair says so, and the rare step with a quotient outside
// that range is computed again with __fdiv_rn.
// * Filter (the common path).  After the first chunk a row's carry holds its
//   C best of i chunks, so about C / i entries of chunk i beat the carry's
//   worst word T.  A step tests its estimates against T as bf16 pairs, and
//   only where a pair may enter compares words and appends the survivors to
//   a buffer of 256 entries a row in shared memory.
// * Full select (a carry not yet filled, a table no longer than the chunk,
//   or a row whose survivors overflow the buffer).  Among the entries below
//   T: a pass histograms the key's high byte, a warp finds the byte of the
//   C-th entry, a second pass histograms the low byte within it, which
//   gives the key K of the C-th entry and how many lie below it; a third
//   pass collects the entries below K and, in column order (a block-wide
//   scan a step), the first of those at K.  The estimate is recomputed each
//   pass: g is read again rather than kept (64 KiB a row), so that blocks
//   stay small and many.  Such rows add to the device counter full_rows,
//   once a block.
// * Merge.  The carry is sorted (the kernel writes it so); each candidate's
//   place is its rank among carry and survivors (a binary search in the
//   carry, a count in the buffer), and the first C places are written.
// The arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which
// nvcc never contracts into an FMA, and bf16 rounding by cvt.rn, as PyTorch's
// kernels do; the clip propagates NaN as torch.clamp does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFilterCap = 256;  // survivors a row the filter keeps before the full select
constexpr int kMaxC = 4096;      // the most candidates a row the kernel keeps
constexpr int kWideMaxC = 128;   // R = 2 blocks take C up to this
constexpr int kWideMinB = 1024;  // and B from this
constexpr int kStages = 2;       // steps of a thread's inputs in shared memory
constexpr uint32_t kAllBelow = 0x10000u;  // a K above every key: take every entry below T

enum : int { kIdle = 0, kFilter = 1, kHistHi = 2, kHistLo = 3, kCollect = 4 };

struct Params {
  const float* g;          // (B, L) fp32, row-major
  const uint32_t* qtab;    // (B,) bf16 pairs: qn^2, 2 qn (inner product: (B,) bf16 qn)
  const uint2* rtab;       // (L,) fp32(1 / ipb) bits; nr, nr^2 as a bf16 pair
  const uint16_t* ipb;     // (L,) bf16(max(ip_bar, 1e-6)), read where the division must be IEEE
  const uint16_t* carry_vals;  // (B, C) bf16 bits, or null: no carry
  const int64_t* carry_ids;    // (B, C)
  uint16_t* out_vals;      // (B, C) bf16 bits
  int64_t* out_ids;        // (B, C)
  unsigned long long* full_rows;  // (1,) count of (row, chunk) pairs that took the full select
  int B, L, C, cap;
  uint32_t row0;           // global id of the chunk's first row
  float inv;               // fp32(1) / fp32(sqrt(d)), as PyTorch divides by a scalar
};

// one query row's state, in shared memory
struct Row {
  uint64_t t;      // an entry enters if its word is below t (the carry's worst)
  float tf;        // t's value as fp32
  float qn2, tq;   // qn^2 and 2 qn as fp32
  int b;           // the query row, or -1 past B
  int mode;        // what the next pass does for the row
  int full;        // took the full select
  unsigned cnt;    // entries written to the buffer by atomics
  int bin, below;  // the full select's byte and the entries below it
  int key;         // the C-th entry's key (kAllBelow: fewer than C entries)
  int need;        // entries at key to take, in column order
  int m;           // entries in the buffer for the merge
};

__device__ __forceinline__ float lo_f32(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_f32(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// bf16 bits -> 16-bit key in ascending value order; -0 = +0, NaN last
__device__ __forceinline__ uint32_t order_key(uint32_t u) {
  const uint32_t a = u & 0x7fffu;
  if (a > 0x7f80u) return 0xffffu;
  return (u & 0x8000u) ? 0x7fffu - a : 0x8000u + a;
}

__device__ __forceinline__ uint64_t word(uint32_t key, uint32_t id, uint32_t bits) {
  return (static_cast<uint64_t>(key) << 48) | (static_cast<uint64_t>(id) << 16) | bits;
}

// BYTES (4, 8 or 16) global -> shared through L1; completes with cp_async_wait
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}

// the chain after the quotient: clip, then qn^2 + nr^2 - ((2 qn) nr) clip,
// for a pair of entries of one row (bf16 pairs in and out); under IP (nr2
// holding cr and tq holding qn) -(cr + (qn nr) clip), the sum rounded to
// bf16 and then negated, as PyTorch negates the bf16 sum
template <bool IP>
__device__ __forceinline__ uint32_t finish_pair(uint32_t quot, float nr0, float nr1, float nr20,
                                                float nr21, float qn2, float tq) {
  const __nv_bfloat162 c2 = __hmin2_nan(__hmax2_nan(as_bf162(quot), __float2bfloat162_rn(-1.f)),
                                        __float2bfloat162_rn(1.f));
  const uint32_t c = *reinterpret_cast<const uint32_t*>(&c2);
  const uint32_t t1 = pack_bf16(__fmul_rn(tq, nr0), __fmul_rn(tq, nr1));
  const uint32_t t2 =
      pack_bf16(__fmul_rn(lo_f32(t1), lo_f32(c)), __fmul_rn(hi_f32(t1), hi_f32(c)));
  if constexpr (IP) {
    return pack_bf16(__fadd_rn(nr20, lo_f32(t2)), __fadd_rn(nr21, hi_f32(t2))) ^ 0x80008000u;
  } else {
    const uint32_t sq = pack_bf16(__fadd_rn(qn2, nr20), __fadd_rn(qn2, nr21));
    return pack_bf16(__fsub_rn(lo_f32(sq), lo_f32(t2)), __fsub_rn(hi_f32(sq), hi_f32(t2)));
  }
}

// Two entries' estimates, the quotient bf16(g' / ipb) (g' = bf16(g / sqrt
// d)) taken as bf16(g' * y) with y = fp32(1 / ipb): both operands carry 8
// significant bits, so their exact quotient lies at least 2^-17 (relative)
// from every bf16 rounding midpoint, and g' * y, within 2^-23 of it, rounds
// to the same bf16 as the IEEE quotient does (checked exhaustively over
// the operands' significands).  That holds while g' * y is a normal number
// or 0 and y is normal (the table stores NaN for y otherwise); slow is set
// where it may not, and the caller then takes ieee_pair.
template <bool IP>
__device__ __forceinline__ uint32_t fast_pair(float g0, float g1, float y0, float y1, float nr0,
                                              float nr1, float nr20, float nr21, float qn2,
                                              float tq, float inv, bool& slow) {
  const uint32_t gs = pack_bf16(__fmul_rn(g0, inv), __fmul_rn(g1, inv));
  const float q0 = __fmul_rn(lo_f32(gs), y0), q1 = __fmul_rn(hi_f32(gs), y1);
  slow |= (!(fabsf(q0) >= 0x1p-100f) && q0 != 0.f) || (!(fabsf(q1) >= 0x1p-100f) && q1 != 0.f);
  return finish_pair<IP>(pack_bf16(q0, q1), nr0, nr1, nr20, nr21, qn2, tq);
}

// the same with the IEEE division of PyTorch's chain, b = bf16(max(ip_bar, 1e-6))
template <bool IP>
__device__ __forceinline__ uint32_t ieee_pair(float g0, float g1, float b0, float b1, float nr0,
                                              float nr1, float nr20, float nr21, float qn2,
                                              float tq, float inv) {
  const uint32_t gs = pack_bf16(__fmul_rn(g0, inv), __fmul_rn(g1, inv));
  return finish_pair<IP>(pack_bf16(__fdiv_rn(lo_f32(gs), b0), __fdiv_rn(hi_f32(gs), b1)), nr0,
                         nr1, nr20, nr21, qn2, tq);
}

// One pass over the chunk for every row whose mode is not kIdle.  Each
// thread stages its own inputs of the next kStages - 1 steps in shared
// memory with cp.async (g of each row it reads, bypassing L1; the columns'
// table entries through L1, where the block's other rows and the SM's other
// blocks find them), so that a step's loads are in flight while the steps
// before it compute; a thread reads only the slots it filled, so the
// stages need no barrier.  A step computes its R x VEC estimates without a
// branch; the filter then tests them against T as bf16 pairs and looks at
// single entries only where a pair may enter.  ORDERED (the collect) ranks
// the entries at each row's key K in column order with a block-wide scan a
// step; every thread runs every step.
template <int R, int VEC, bool IP, bool ORDERED>
__device__ void run_pass(const Params& p, Row* rows, uint64_t* buf, uint32_t* hist,
                         uint64_t* scan, uint4* stage) {
  static_assert(R <= 4, "the collect packs R counts of 16 bits");
  constexpr int P = (VEC + 1) / 2;  // bf16 pairs of a row a step (VEC 1: one entry, twice)
  int mode[R], sel[R], nl[R], need[R], taken[R];
  uint64_t t[R];
  uint32_t tpair[R];
  float qn2[R], tq[R];
  const float* grow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mode[r] = rows[r].mode;
    t[r] = rows[r].t;
    tpair[r] = static_cast<uint32_t>(t[r] & 0xffffu) * 0x10001u;
    qn2[r] = rows[r].qn2;
    tq[r] = rows[r].tq;
    sel[r] = mode[r] == kHistLo ? rows[r].bin : rows[r].key;
    nl[r] = rows[r].below;
    need[r] = rows[r].need;
    taken[r] = 0;
    grow[r] = p.g + static_cast<int64_t>(rows[r].b < 0 ? 0 : rows[r].b) * p.L;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int tile = kThreads * VEC;
  const int steps = (p.L + tile - 1) / tile;
  // slot j of a stage: one 16-byte word a thread; j < R: row j's g, R and
  // R + 1: the table entries of the thread's VEC columns
  auto slots = [&](int s) { return stage + (s % kStages) * (R + 2) * kThreads + threadIdx.x; };
  auto issue = [&](int s) {
    const int c = s * tile + threadIdx.x * VEC;
    if (s < steps && c < p.L) {
      uint4* st = slots(s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (mode[r] == kIdle) continue;
        if constexpr (VEC == 4) cp_async16(st + r * kThreads, grow[r] + c);
        else cp_async_ca<4>(st + r * kThreads, grow[r] + c);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        cp_async_ca<8>(reinterpret_cast<uint2*>(st + (R + v / 2) * kThreads) + (v & 1),
                       p.rtab + c + v);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    const int c = s * tile + threadIdx.x * VEC;
    cp_async_wait<kStages - 2>();
    const uint4* st = slots(s);
    float gv[R][VEC], y[VEC], nr[VEC], nr2[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const uint2 e = reinterpret_cast<const uint2*>(st + (R + v / 2) * kThreads)[v & 1];
      y[v] = __uint_as_float(e.x);
      nr[v] = lo_f32(e.y);
      nr2[v] = hi_f32(e.y);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (VEC == 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (mode[r] != kIdle) x = *reinterpret_cast<const float4*>(st + r * kThreads);
        gv[r][0] = x.x, gv[r][1] = x.y, gv[r][2] = x.z, gv[r][3] = x.w;
      } else {
        gv[r][0] = mode[r] != kIdle ? *reinterpret_cast<const float*>(st + r * kThreads) : 0.f;
      }
    }
    issue(s + kStages - 1);
    if (c >= p.L) {
      if constexpr (!ORDERED) continue;
    }
    uint32_t e[R][P];
    bool slow = false;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const int v0 = 2 * h, v1 = VEC > 1 ? 2 * h + 1 : 2 * h;
        e[r][h] = fast_pair<IP>(gv[r][v0], gv[r][v1], y[v0], y[v1], nr[v0], nr[v1], nr2[v0],
                            nr2[v1], qn2[r], tq[r], p.inv, slow);
      }
    if (slow && c < p.L) {  // some quotient outside fast_pair's range: IEEE division
      float b[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) b[v] = lo_f32(p.ipb[c + v]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int h = 0; h < P; ++h) {
          const int v0 = 2 * h, v1 = VEC > 1 ? 2 * h + 1 : 2 * h;
          e[r][h] = ieee_pair<IP>(gv[r][v0], gv[r][v1], b[v0], b[v1], nr[v0], nr[v1], nr2[v0],
                              nr2[v1], qn2[r], tq[r], p.inv);
        }
    }
    uint32_t ties[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ties[r] = 0;
    if (c < p.L) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (mode[r] == kIdle) continue;
        if (mode[r] == kFilter) {
          // !(e > T) by pairs (NaN passes: the word decides): any pair that may enter?
          uint32_t may = 0;
#pragma unroll
          for (int h = 0; h < P; ++h) {
            const __nv_bfloat162 m = __hleu2(as_bf162(e[r][h]), as_bf162(tpair[r]));
            may |= *reinterpret_cast<const uint32_t*>(&m);
          }
          if (!may) continue;
        }
        if (mode[r] == kHistHi) {
          // most entries of a row share a few high bytes (sign and exponent):
          // one atomic for the thread's VEC entries where they share one
          uint32_t bin[VEC], first = 0xffffffffu;
          bool all = true;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const uint32_t bits = (e[r][v / 2] >> (16 * (v & 1))) & 0xffffu;
            const uint32_t k = order_key(bits);
            const bool in = word(k, p.row0 + static_cast<uint32_t>(c + v), bits) < t[r];
            bin[v] = in ? k >> 8 : 0xffffffffu;
            if (v == 0) first = bin[v];
            all = all && bin[v] == first;
          }
          if (all && first != 0xffffffffu) {
            atomicAdd(&hist[r * 256 + first], static_cast<unsigned>(VEC));
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              if (bin[v] != 0xffffffffu) atomicAdd(&hist[r * 256 + bin[v]], 1u);
          }
          continue;
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const uint32_t bits = (e[r][v / 2] >> (16 * (v & 1))) & 0xffffu;
          const uint32_t id = p.row0 + static_cast<uint32_t>(c + v);
          const uint32_t k = order_key(bits);
          const uint64_t w = word(k, id, bits);
          if (mode[r] == kFilter) {
            if (w < t[r]) {
              const unsigned pos = atomicAdd(&rows[r].cnt, 1u);
              if (pos < static_cast<unsigned>(p.cap)) buf[r * p.cap + pos] = w;
            }
          } else if (mode[r] == kHistLo) {
            if (static_cast<int>(k >> 8) == sel[r] && w < t[r])
              atomicAdd(&hist[r * 256 + (k & 0xffu)], 1u);
          } else if (static_cast<int>(k) <= sel[r] && w < t[r]) {  // kCollect
            if (static_cast<int>(k) < sel[r])
              buf[r * p.cap + atomicAdd(&rows[r].cnt, 1u)] = w;
            else
              ties[r] |= 1u << v;
          }
        }
      }
    }
    if constexpr (ORDERED) {
      uint64_t mine = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) mine |= static_cast<uint64_t>(__popc(ties[r])) << (16 * r);
      uint64_t x = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint64_t yv = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += yv;
      }
      if (lane == 31) scan[warp] = x;
      __syncthreads();
      uint64_t before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint64_t sw = scan[w];
        before += w < warp ? sw : 0;
        total += sw;
      }
      __syncthreads();  // scan[] is written again next step
      before += x - mine;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (mode[r] != kCollect) continue;
        int rank = taken[r] + static_cast<int>((before >> (16 * r)) & 0xffffu);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          if (!((ties[r] >> v) & 1u)) continue;
          if (rank < need[r]) {
            const uint32_t bits = (e[r][v / 2] >> (16 * (v & 1))) & 0xffffu;
            buf[r * p.cap + nl[r] + rank] =
                word(static_cast<uint32_t>(sel[r]), p.row0 + static_cast<uint32_t>(c + v), bits);
          }
          ++rank;
        }
        taken[r] += static_cast<int>((total >> (16 * r)) & 0xffffu);
      }
    }
  }
  cp_async_wait<0>();
}

// The smallest byte b of a 256-bin histogram at which the running count
// reaches target, and the count below it; (256, total) when it never does.
// One warp.
__device__ void find_bin(const uint32_t* hist, int target, int lane, int& bin, int& below) {
  uint32_t s[8], mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = hist[lane * 8 + j];
    mine += s[j];
  }
  uint32_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const uint32_t excl = incl - mine, total = __shfl_sync(0xffffffffu, incl, 31);
  const uint32_t tgt = static_cast<uint32_t>(target);
  if (total < tgt) {
    bin = 256;
    below = static_cast<int>(total);
    return;
  }
  const bool mine_holds = excl < tgt && tgt <= incl;
  int b = 0, acc = 0;
  if (mine_holds) {  // the first of this lane's bins at which the count reaches tgt
    uint32_t run = excl;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found && run + s[j] >= tgt) {
        b = lane * 8 + j;
        acc = static_cast<int>(run);
        found = true;
      }
      run += s[j];
    }
  }
  const unsigned who = __ballot_sync(0xffffffffu, mine_holds);
  const int src = __ffs(who) - 1;
  bin = __shfl_sync(0xffffffffu, b, src);
  below = __shfl_sync(0xffffffffu, acc, src);
}

// The full select of the rows marked full, their high-byte histogram
// already taken: the low-byte pass, then the collect, which leaves each
// such row's C best entries below T (fewer where fewer lie below it) in
// its buffer.
template <int R, int VEC, bool IP>
__device__ void full_select(const Params& p, Row* rows, uint64_t* buf, uint32_t* hist,
                            uint64_t* scan, uint4* stage, int* flags) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, C = p.C;
  if (warp < R && rows[warp].full) {
    int bin, below;
    find_bin(hist + warp * 256, C, lane, bin, below);
    if (lane == 0) {
      Row& w = rows[warp];
      w.bin = bin;
      w.below = below;
      w.mode = bin < 256 ? kHistLo : kIdle;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * 256; i += kThreads) hist[i] = 0;
  if (tid == 0) {
    int lo = 0;
    for (int r = 0; r < R; ++r) lo |= rows[r].mode == kHistLo;
    flags[2] = lo;
  }
  __syncthreads();
  if (flags[2]) {
    run_pass<R, VEC, IP, false>(p, rows, buf, hist, scan, stage);
    __syncthreads();
  }
  if (warp < R && rows[warp].full) {
    Row& w = rows[warp];
    if (w.bin < 256) {
      int b2, below2;
      find_bin(hist + warp * 256, C - w.below, lane, b2, below2);
      if (lane == 0) {
        w.key = (w.bin << 8) | b2;
        w.below += below2;  // entries below the key: the collect's first slots
        w.need = C - w.below;
      }
    } else if (lane == 0) {
      w.key = static_cast<int>(kAllBelow);
      w.below = w.need = 0;
    }
    if (lane == 0) {
      w.cnt = 0;
      w.mode = kCollect;
    }
  }
  __syncthreads();
  run_pass<R, VEC, IP, true>(p, rows, buf, hist, scan, stage);
  __syncthreads();
  if (tid < R && rows[tid].full) {
    Row& w = rows[tid];
    w.m = w.key == static_cast<int>(kAllBelow) ? static_cast<int>(w.cnt) : C;
  }
  __syncthreads();
}

template <int R, int VEC, bool IP>
__device__ __forceinline__ void scan_select_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* stage = reinterpret_cast<uint4*>(smem);
  Row* rows = reinterpret_cast<Row*>(stage + kStages * (R + 2) * kThreads);
  uint64_t* carry = reinterpret_cast<uint64_t*>(rows) + (R * sizeof(Row) + 15) / 16 * 2;
  const int C = p.C, cin = p.carry_vals ? C : 0;
  uint64_t* buf = carry + R * cin;
  uint64_t* scan = buf + R * p.cap;
  uint32_t* hist = reinterpret_cast<uint32_t*>(scan + kWarps);
  __shared__ int flags[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * R;

  for (int i = tid; i < R * cin; i += kThreads) {
    const int r = i / cin, j = i - r * cin, b = b0 + r;
    uint64_t w = ~0ull;
    if (b < p.B) {
      const int64_t o = static_cast<int64_t>(b) * C + j;
      const uint32_t v = p.carry_vals[o];
      w = word(order_key(v), static_cast<uint32_t>(p.carry_ids[o]), v);
    }
    carry[i] = w;
  }
  for (int i = tid; i < R * 256; i += kThreads) hist[i] = 0;
  __syncthreads();
  if (tid < R) {
    Row& w = rows[tid];
    const int b = b0 + tid;
    w.b = b < p.B ? b : -1;
    w.t = cin ? carry[tid * cin + cin - 1] : ~0ull;
    w.tf = __uint_as_float(static_cast<uint32_t>(w.t & 0xffffu) << 16);
    // a carry not yet filled (its worst still the first carry's 3e38), or
    // none: the filter would keep everything, so select in full at once
    const bool direct = !cin || !(w.tf < 1e38f);
    w.mode = w.b < 0 ? kIdle : (direct ? kHistHi : kFilter);
    w.full = w.mode == kHistHi;
    w.cnt = 0;
    w.bin = w.below = w.key = w.need = w.m = 0;
    if constexpr (IP) {
      const uint32_t q = w.b < 0 ? 0u : reinterpret_cast<const uint16_t*>(p.qtab)[w.b];
      w.qn2 = 0.f;
      w.tq = lo_f32(q);
    } else {
      const uint32_t q = w.b < 0 ? 0u : p.qtab[w.b];
      w.qn2 = lo_f32(q);
      w.tq = hi_f32(q);
    }
  }
  __syncthreads();
  run_pass<R, VEC, IP, false>(p, rows, buf, hist, scan, stage);
  __syncthreads();
  if (tid == 0) {
    int late = 0, full = 0;
    for (int r = 0; r < R; ++r) {
      Row& w = rows[r];
      if (w.mode == kFilter && w.cnt > static_cast<unsigned>(p.cap)) {
        w.mode = kHistHi;  // the buffer overflowed: select this row in full
        w.full = 1;
        late = 1;
      } else {
        if (w.mode == kFilter) w.m = static_cast<int>(w.cnt);
        w.mode = kIdle;
      }
      full += w.full;
    }
    if (full) atomicAdd(p.full_rows, static_cast<unsigned long long>(full));
    flags[0] = late;
    flags[1] = full;
  }
  __syncthreads();
  if (flags[0]) {  // the high-byte pass of the rows that overflowed
    run_pass<R, VEC, IP, false>(p, rows, buf, hist, scan, stage);
    __syncthreads();
  }
  if (flags[1]) full_select<R, VEC, IP>(p, rows, buf, hist, scan, stage, flags);

  // each candidate's place among the carry (sorted) and the buffer
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const int b = rows[r].b, m = rows[r].m;
    if (b < 0) continue;
    const uint64_t* cr = carry + r * cin;
    const uint64_t* br = buf + r * p.cap;
    for (int i = tid; i < cin + m; i += kThreads) {
      uint64_t w;
      int pos = 0;
      if (i < cin) {
        w = cr[i];
        pos = i;
        for (int j = 0; j < m; ++j) pos += br[j] < w;
      } else {
        w = br[i - cin];
        int lo = 0, hi = cin;  // carried words <= w go first
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cr[mid] <= w) lo = mid + 1;
          else hi = mid;
        }
        pos = lo;
        for (int j = 0; j < m; ++j) pos += br[j] < w;
      }
      if (pos < C) {
        const int64_t o = static_cast<int64_t>(b) * C + pos;
        p.out_vals[o] = static_cast<uint16_t>(w & 0xffffu);
        p.out_ids[o] = static_cast<int64_t>((w >> 16) & 0xffffffffu);
      }
    }
  }
}

template <int R, int VEC>
__global__ void __launch_bounds__(kThreads, 4) scan_select_kernel(const Params p) {
  scan_select_body<R, VEC, false>(p);
}

template <int R, int VEC>
__global__ void __launch_bounds__(kThreads, 4) scan_select_ip_kernel(const Params p) {
  scan_select_body<R, VEC, true>(p);
}

template <int R, int VEC, bool IP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int cin = p.carry_vals ? p.C : 0;
  const size_t smem = static_cast<size_t>(kStages) * (R + 2) * kThreads * 16 +
                      ((R * sizeof(Row) + 15) / 16) * 16 +
                      (static_cast<size_t>(R) * (cin + p.cap) + kWarps) * sizeof(uint64_t) +
                      R * 256 * sizeof(uint32_t);
  auto kernel = IP ? scan_select_ip_kernel<R, VEC> : scan_select_kernel<R, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(p.B + R - 1) / R, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool IP>
int scan_select_entry(const float* g, const void* qtab, const void* rtab, const void* ipb,
                      const void* carry_vals, const int64_t* carry_ids, void* out_vals,
                      int64_t* out_ids, int64_t* full_rows, int B, int L, int C, int64_t row0,
                      float inv, int device, void* stream) {
  if (B < 1 || L < 1 || C < 1 || C > kMaxC || row0 < 0 || row0 + L > (int64_t{1} << 32) ||
      (!carry_vals) != (!carry_ids) || (!carry_vals && L < C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.g = g;
  p.qtab = static_cast<const uint32_t*>(qtab);
  p.rtab = static_cast<const uint2*>(rtab);
  p.ipb = static_cast<const uint16_t*>(ipb);
  p.carry_vals = static_cast<const uint16_t*>(carry_vals);
  p.carry_ids = carry_ids;
  p.out_vals = static_cast<uint16_t*>(out_vals);
  p.out_ids = out_ids;
  p.full_rows = reinterpret_cast<unsigned long long*>(full_rows);
  p.B = B;
  p.L = L;
  p.C = C;
  p.cap = C > kFilterCap ? C : kFilterCap;
  p.row0 = static_cast<uint32_t>(row0);
  p.inv = inv;
  const bool wide = B >= kWideMinB && C <= kWideMaxC;
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    err = vec ? launch<2, 4, IP>(p, s) : launch<2, 1, IP>(p, s);
  else
    err = vec ? launch<1, 4, IP>(p, s) : launch<1, 1, IP>(p, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entries for ctypes.  g (B, L) fp32 row-major; qtab (B, 2) bf16
// (scan_select_ip_bf16: (B, 1));
// rtab (L, 2) int32 and ipb (L,) bf16, the chunk's rows; carry_vals (B, C)
// bf16 and carry_ids (B, C) int64, sorted ascending by (value, id) in each
// row with ids below 2^32, or both null for no carry (then L >= C);
// out_vals (B, C) bf16, out_ids (B, C) int64; full_rows one int64.
// row0 + L <= 2^32.  scan_select_bf16 takes squared L2's tables,
// scan_select_ip_bf16 inner product's (kernels/scan_select/kernel.py::tables).
// Each returns the launch's cudaError_t; 0 is success.
extern "C" int scan_select_bf16(const float* g, const void* qtab, const void* rtab,
                                const void* ipb, const void* carry_vals, const int64_t* carry_ids,
                                void* out_vals, int64_t* out_ids, int64_t* full_rows, int B,
                                int L, int C, int64_t row0, float inv, int device,
                                void* stream) {
  return scan_select_entry<false>(g, qtab, rtab, ipb, carry_vals, carry_ids, out_vals, out_ids,
                                  full_rows, B, L, C, row0, inv, device, stream);
}

extern "C" int scan_select_ip_bf16(const float* g, const void* qtab, const void* rtab,
                                   const void* ipb, const void* carry_vals,
                                   const int64_t* carry_ids, void* out_vals, int64_t* out_ids,
                                   int64_t* full_rows, int B, int L, int C, int64_t row0,
                                   float inv, int device, void* stream) {
  return scan_select_entry<true>(g, qtab, rtab, ipb, carry_vals, carry_ids, out_vals, out_ids,
                                 full_rows, B, L, C, row0, inv, device, stream);
}
