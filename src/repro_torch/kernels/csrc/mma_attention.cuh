// Tensor-core tile core of the float paged-prefill and flash attention
// kernels (sm_90a), shaped as FlashAttention-2.
//
// One CTA of four warps holds up to 64 query rows that share one KV head
// (the GQA group times a tile of positions); warp w owns rows 16w..16w+15
// and keeps their q fragments (bf16; f32 below), their f32 output
// accumulators and their online-softmax state in registers for the whole
// key loop.  Keys come in tiles of 64 through a ring of stages in shared
// memory (three in bf16, two in f32): the 16-byte cp.async copies of the
// next tiles are in flight while tile t computes, one barrier per tile.
// Per tile and warp:
//
//   S = Q K^T       mma.sync, f32 accumulators (16 rows x 64 keys)
//   mask            -inf, only on tiles that cross a mask edge
//   m_new = max(m, rowmax S),  P = exp2((S - m_new) log2(e) / sqrt(D))
//   l = l * alpha + rowsum P,  O = O * alpha + P V   (P stays in registers)
//
// A masked key's probability is exp2(-inf) = 0 exactly, and at the end
// out = O / max(l, 1e-20), so a row that saw no key writes 0 (the TPU
// kernels' denominator floor).  Row max and sum reduce over the four lanes
// of a quad, which share a row of every mma fragment.
//
// Products per dtype, one design each, fixed at compile time:
//   bfloat16  mma.m16n8k16 bf16 x bf16 -> f32; K through ldmatrix, V
//             through ldmatrix.trans, P rounded to bf16 as the A operand;
//   float32   3xTF32: each operand split into a TF32 high part and a TF32
//             residual, and mma.m16n8k8 TF32 runs hi.lo + lo.hi + hi.hi
//             into f32 accumulators, which keeps f32 accuracy (TF32 alone
//             keeps 10 mantissa bits and would not).  q is split once and
//             kept in shared memory, as registers cannot hold it beside
//             the f32 output and the scores at D 128.  The P.V product
//             contracts over keys in the order (0, 2, 4, 6, 1, 3, 5, 7) of
//             each 8-key block, so the accumulator fragment of S is the A
//             fragment of P with no shuffle.
//
// D is padded to Dp, a multiple of 16 fixed at compile time; shared rows
// are Dp elements plus 16 bytes, so the 8 rows an ldmatrix phase or a TF32
// fragment load touches fall in distinct banks.  Columns past D and key
// rows past a tile's end are zero-filled in shared memory (0 * NaN is not
// 0, so no stale value may reach a product).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace mma_attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per CTA, 16 per warp
constexpr int kTileN = 64;          // keys per tile
constexpr int kRowThreads = kThreads / kTileN;  // loader threads a key row (prefill, flash)
// tiles in the shared ring: f32 at Dp 128 fits only two beside its q
constexpr int kStagesF32 = 2;
constexpr int kStagesBf16 = 3;
constexpr int kMinBlocks = 1;       // launch bounds: up to 255 registers
constexpr float kNegInf = -INFINITY;
constexpr float kLog2e = 1.4426950408889634f;

// Shared layout of one dtype and padded width: the ring holds kStages
// (K tile, V tile) pairs of kTileN rows of kStride elements; in f32 the
// q fragments follow it.
template <typename T, int Dp>
struct Layout {
  static_assert(Dp % 16 == 0 && Dp >= 16 && Dp <= 128, "Dp: 16..128 step 16");
  static constexpr int kPer = 16 / (int)sizeof(T);  // elements per 16-byte piece
  static constexpr int kStride = Dp + kPer;         // elements per shared row
  static constexpr int kPieces = Dp / kPer;         // pieces per padded row
  static constexpr int kTile = kTileN * kStride;    // elements per K or V tile
  static constexpr int kStages = sizeof(T) == 4 ? kStagesF32 : kStagesBf16;
  static constexpr size_t kRing = sizeof(T) * 2 * kStages * kTile;
  // f32 only: each thread's q fragments as TF32 high parts and residuals
  static constexpr size_t kQSmem = sizeof(T) == 4 ? 4 * Dp * kThreads : 0;
  static constexpr size_t kSmem = kRing + kQSmem;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x to a few ulp (the MUFU unit); exactly 0 at -inf
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// x = hi + lo, hi the TF32 value nearest x (ties away from zero, as
// cvt.rna, which the card emulates in several instructions) and lo the
// exact f32 residual, offset by half a TF32 ulp so that the mma's reading
// of its top 19 bits rounds it: 4 integer / float operations a value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------
// Tile loader
// ---------------------------------------------------------------------------

// Start copying one key tile into the stage buffers ks / vs.  RowThreads
// threads share a row: thread t copies the kRpt = kTileN * RowThreads /
// kThreads consecutive tile rows j = t / RowThreads * kRpt + p, every
// RowThreads-th piece from t % RowThreads.  With two threads a row
// (prefill, flash) each pair of lanes reads one 32-byte sector a step;
// with eight (decode) eight lanes read one whole 128-byte row, and a
// warp's four loader groups read 16 consecutive rows (one 16-token page)
// in four steps.  Rows j < nk come from global row ``row[p]`` of k and v
// (D elements each; the caller computed it a tile ahead); rows j >= nk
// and columns >= D are zero-filled.  With ``vec`` (every row 16-byte
// aligned: D * sizeof(T) % 16 == 0 and aligned bases) the copies are
// 16-byte cp.async pieces; otherwise element by element through
// registers (D not a multiple of 8 in bf16, of 4 in f32).  The caller's
// barrier after cp_async_wait() publishes either.
template <typename T, int Dp, int RowThreads,
          int kRpt = kTileN * RowThreads / kThreads>
__device__ __forceinline__ void load_tile(T* ks, T* vs,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const size_t (&row)[kRpt], int nk,
                                          int D, bool vec) {
  using L = Layout<T, Dp>;
  const int par = threadIdx.x % RowThreads;
#pragma unroll
  for (int p = 0; p < kRpt; ++p) {
    const int j = threadIdx.x / RowThreads * kRpt + p;
    T* kd = ks + j * L::kStride;
    T* vd = vs + j * L::kStride;
    if (j < nk) {
      const T* kg = k + row[p] * D;
      const T* vg = v + row[p] * D;
      if (vec) {
        const int n = D / L::kPer;  // pieces that hold data
#pragma unroll
        for (int i = par; i < L::kPieces; i += RowThreads) {
          if (i < n) {
            cp_async16(kd + i * L::kPer, kg + i * L::kPer);
            cp_async16(vd + i * L::kPer, vg + i * L::kPer);
          } else {
            zero16(kd + i * L::kPer);
            zero16(vd + i * L::kPer);
          }
        }
      } else {
        const T z = from_float<T>(0.f);
#pragma unroll 4
        for (int d = par; d < Dp; d += RowThreads) {
          kd[d] = d < D ? kg[d] : z;
          vd[d] = d < D ? vg[d] : z;
        }
      }
    } else {
#pragma unroll
      for (int i = par; i < L::kPieces; i += RowThreads) {
        zero16(kd + i * L::kPer);
        zero16(vd + i * L::kPer);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Products of one warp's 16 rows
// ---------------------------------------------------------------------------

// Lane roles in every mma fragment: group g = lane / 4 (rows g, g + 8),
// t4 = lane % 4 (columns 2 t4, 2 t4 + 1 of each 8-column block).
template <typename T, int Dp>
struct Mma;

template <int Dp>
struct Mma<__nv_bfloat16, Dp> {
  using T = __nv_bfloat16;
  using L = Layout<T, Dp>;
  uint32_t qa[Dp / 16][4];  // A fragments of the 16 x Dp q slab

  // q0 / q1: this lane's rows g and g + 8 (nullptr: a padding row); the
  // fragments stay in registers (kQSmem is 0)
  __device__ __forceinline__ void load_q(uint32_t*, const T* q0, const T* q1,
                                         int D) {
    const int t4 = threadIdx.x & 3;
    const T z = __float2bfloat16(0.f);
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kk * 16 + h * 8 + 2 * t4;
        qa[kk][2 * h] = pack_bf16(q0 && c < D ? q0[c] : z,
                                  q0 && c + 1 < D ? q0[c + 1] : z);
        qa[kk][2 * h + 1] = pack_bf16(q1 && c < D ? q1[c] : z,
                                      q1 && c + 1 < D ? q1[c + 1] : z);
      }
  }

  // s[n] = q . k for the keys 8n .. 8n + 7 of the NB * 8 keys at ks
  template <int NB>
  __device__ __forceinline__ void scores(const T* ks, float (&s)[NB][4]) const {
    const int lane = threadIdx.x & 31;
    // x4 matrices: (keys +0, cols +0), (keys +0, cols +8), (keys +8, cols
    // +0), (keys +8, cols +8) -> b0, b1 of key block 2n2 and of 2n2 + 1
    const uint32_t base = smem_u32(ks + ((lane >> 4) * 8 + (lane & 7)) * L::kStride +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2)
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, base + (uint32_t)(n2 * 16 * L::kStride + kk * 16) * 2u);
        mma_bf16(s[2 * n2], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], qa[kk], b[2], b[3]);
      }
  }

  // o += p . v over the NB * 8 keys at vs (p: the probabilities in s's
  // layout)
  template <int NB>
  __device__ __forceinline__ void pv(const T* vs, const float (&p)[NB][4],
                                     float (&o)[Dp / 8][4]) const {
    const int lane = threadIdx.x & 31;
    // x4.trans matrices: (keys +0, cols +0), (keys +8, cols +0), (keys +0,
    // cols +8), (keys +8, cols +8) -> b0, b1 of d block 2d2 and of 2d2 + 1
    const uint32_t base = smem_u32(vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * L::kStride +
                                   (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < Dp / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, base + (uint32_t)(kk * 16 * L::kStride + d2 * 16) * 2u);
        mma_bf16(o[2 * d2], a, b[0], b[1]);
        mma_bf16(o[2 * d2 + 1], a, b[2], b[3]);
      }
    }
  }
};

template <int Dp>
struct Mma<float, Dp> {
  using T = float;
  using L = Layout<T, Dp>;
  // This lane's A fragments of the q slab, split once into TF32 high
  // parts and residuals, in thread-private shared memory (kQSmem): q, the
  // f32 output and the scores do not fit in registers together at Dp 128.
  // Word (kk * 4 + e) * kThreads + thread, so a warp's loads hit 32 banks.
  const uint32_t* qh;
  const uint32_t* ql;

  __device__ __forceinline__ void load_q(uint32_t* qs, const T* q0, const T* q1,
                                         int D) {
    const int t4 = threadIdx.x & 3;
    uint32_t* hi = qs + threadIdx.x;
    uint32_t* lo = hi + (Dp / 2) * kThreads;
#pragma unroll
    for (int kk = 0; kk < Dp / 8; ++kk) {
      const int c = kk * 8 + t4;
      const float a[4] = {q0 && c < D ? q0[c] : 0.f, q1 && c < D ? q1[c] : 0.f,
                          q0 && c + 4 < D ? q0[c + 4] : 0.f,
                          q1 && c + 4 < D ? q1[c + 4] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(a[e], hi[(kk * 4 + e) * kThreads], lo[(kk * 4 + e) * kThreads]);
    }
    qh = hi;
    ql = lo;
  }

  template <int NB>
  __device__ __forceinline__ void scores(const T* ks, float (&s)[NB][4]) const {
    const int lane = threadIdx.x & 31;
    // b0 = k[key 8n + g][col 8kk + t4], b1 = col + 4
    const T* kb = ks + (lane >> 2) * L::kStride + (lane & 3);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Dp / 8; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[e] = qh[(kk * 4 + e) * kThreads];
        al[e] = ql[(kk * 4 + e) * kThreads];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const T* kp = kb + n * 8 * L::kStride + kk * 8;
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(kp[0], b0h, b0l);
        split_tf32(kp[4], b1h, b1l);
        mma_tf32(s[n], al, b0h, b1h);
        mma_tf32(s[n], ah, b0l, b1l);
        mma_tf32(s[n], ah, b0h, b1h);
      }
    }
  }

  // The contraction index k of m16n8k8 maps to key 2k (k < 4) or 2(k - 4)
  // + 1 of each 8-key block: a0 = p[row g][key 2 t4] = s fragment element
  // 0, a1 = row g + 8 (element 2), a2 = key 2 t4 + 1 (element 1), a3 =
  // element 3; b0 = v[key 2 t4][col g], b1 = v[key 2 t4 + 1][col g].
  template <int NB>
  __device__ __forceinline__ void pv(const T* vs, const float (&p)[NB][4],
                                     float (&o)[Dp / 8][4]) const {
    const int lane = threadIdx.x & 31;
    const T* vb = vs + 2 * (lane & 3) * L::kStride + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint32_t ah[4], al[4];
      split_tf32(p[n][0], ah[0], al[0]);
      split_tf32(p[n][2], ah[1], al[1]);
      split_tf32(p[n][1], ah[2], al[2]);
      split_tf32(p[n][3], ah[3], al[3]);
#pragma unroll
      for (int dd = 0; dd < Dp / 8; ++dd) {
        const T* vp = vb + n * 8 * L::kStride + dd * 8;
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(vp[0], b0h, b0l);
        split_tf32(vp[L::kStride], b1h, b1l);
        mma_tf32(o[dd], al, b0h, b1h);
        mma_tf32(o[dd], ah, b0l, b1l);
        mma_tf32(o[dd], ah, b0h, b1h);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Rows, masks and the key loop
// ---------------------------------------------------------------------------

// This lane's two query rows, r = 16 warp + g (+ 8): head head0 + r / TQ,
// position pos0 + r % TQ; ``live`` when r < rows and the position < L.
struct RowPair {
  int pos[2];
  size_t head[2];
  bool live[2];
  __device__ __forceinline__ RowPair(size_t head0, int rows, int TQ, int pos0,
                                     int L) {
    const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      pos[h] = pos0 + r % TQ;
      head[h] = head0 + r / TQ;
      live[h] = r < rows && pos[h] < L;
    }
  }
};

// Which keys of a tile a row at position ``pos`` sees: tile key j (global
// key j0 + j) iff j < nk, and j0 + j <= pos when causal, and j0 + j > pos
// - window when window > 0.  ``full``: every key of the tile is visible
// to every row of the CTA, so the per-element mask is skipped.
struct TileMask {
  int j0, nk, causal, window;
  bool full;
  __device__ __forceinline__ bool operator()(int pos, int j) const {
    const int key = j0 + j;
    return j < nk && (!causal || key <= pos) && (window <= 0 || key > pos - window);
  }
};

// Online-softmax state and output accumulators of one lane's two rows.
// Scores stay in raw units (q . k); the scale 1/sqrt(D) and log2(e) enter
// each exponent through one FFMA.  A masked score is -inf, so exp2 gives
// exactly 0 with no select, and while a row has seen no key its exponent
// offset is 0 instead of -inf (which would make -inf - -inf = NaN).
template <int Dp>
struct Softmax {
  float o[Dp / 8][4];
  float m[2], l[2];  // running raw max, this lane's partial sums

  __device__ __forceinline__ Softmax() {
#pragma unroll
    for (int d = 0; d < Dp / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // Turn scores s (NB 8-key blocks) into probabilities in place and
  // rescale o and l.
  template <int NB>
  __device__ __forceinline__ void fold(float (&s)[NB][4], const TileMask& mask,
                                       const RowPair& rp, float scale_log2) {
    const int t4 = threadIdx.x & 3;
    if (!mask.full) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!mask(rp.pos[e >> 1], 8 * n + 2 * t4 + (e & 1))) s[n][e] = kNegInf;
    }
    float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1][n & 1] = fmaxf(mx[e >> 1][n & 1], s[n][e]);
    float alpha[2], off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = fmaxf(mx[h][0], mx[h][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[h], x);
      off[h] = m_new == kNegInf ? 0.f : m_new * scale_log2;
      alpha[h] = exp2_approx(fmaf(m[h], scale_log2, -off[h]));  // 0 at the first key
      m[h] = m_new;
    }
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, -off[h]));
        sum[h][n & 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + (sum[h][0] + sum[h][1]);
#pragma unroll
    for (int d = 0; d < Dp / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
  }

  // out = o / max(l, 1e-20) for the live rows; row h at dst[h] (D wide)
  template <typename T>
  __device__ __forceinline__ void write(T* const (&dst)[2], int D) {
    const int t4 = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tot = l[h];
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
      const float inv = 1.f / fmaxf(tot, 1e-20f);
      if (dst[h] == nullptr) continue;
#pragma unroll
      for (int d = 0; d < Dp / 8; ++d) {
        const int c = 8 * d + 2 * t4;
        if (c < D) dst[h][c] = from_float<T>(o[d][2 * h] * inv);
        if (c + 1 < D) dst[h][c + 1] = from_float<T>(o[d][2 * h + 1] * inv);
      }
    }
  }
};

// The key loop of one CTA over the tiles of ``tiles``: tiles.n tiles;
// tile t holds tiles.nk(t) keys at rows tiles.row(t, j) of tiles.k(t) /
// tiles.v(t), and tiles.mask(t) says which of them each row sees.  A ring
// of kStages stages and one barrier per tile: copy group g holds tile g,
// so waiting until kStages - 2 groups are in flight lands tile t; after
// the barrier every warp is done with tile t - 1, so tile t + kStages - 1
// may land in that stage while tile t computes.  Each thread's source row
// for the next tile (a block-table read, for pages) is computed a tile
// ahead, so its latency hides behind the products.  Warps whose 16 rows
// are all padding (``compute`` false) only copy.  With KS > 1, KS warps
// share one row tile: warp w takes keys (w % KS) * 64 / KS .. + 64 / KS of
// every tile into its own softmax state, which the caller merges.
// RowThreads loader threads share a key row (load_tile).
template <typename T, int Dp, int KS = 1, int RowThreads = kRowThreads,
          typename Tiles>
__device__ __forceinline__ void key_loop(T* ring, const Tiles& tiles,
                                         const Mma<T, Dp>& mma, Softmax<Dp>& sm,
                                         const RowPair& rp, float scale_log2,
                                         int D, bool vec, bool compute) {
  using L = Layout<T, Dp>;
  constexpr int S = L::kStages;
  constexpr int kRpt = kTileN * RowThreads / kThreads;  // rows per loader thread
  const int n_tiles = tiles.n;
  const auto rows_of = [&](int t, size_t (&rows)[kRpt]) {
#pragma unroll
    for (int p = 0; p < kRpt; ++p) {
      const int j = threadIdx.x / RowThreads * kRpt + p;
      rows[p] = t < n_tiles && j < tiles.nk(t) ? tiles.row(t, j) : 0;
    }
  };
  const auto issue = [&](int t, const size_t (&rows)[kRpt]) {
    T* ks = ring + (t % S) * 2 * L::kTile;
    load_tile<T, Dp, RowThreads>(ks, ks + L::kTile, tiles.k(t), tiles.v(t),
                                 rows, tiles.nk(t), D, vec);
  };
  size_t next[kRpt];
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_tiles) {
      rows_of(t, next);
      issue(t, next);
    }
    cp_async_commit();
  }
  rows_of(S - 1, next);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + S - 1 < n_tiles) issue(t + S - 1, next);
    cp_async_commit();
    rows_of(t + S, next);
    if (compute) {
      constexpr int kKeys = kTileN / KS;  // this warp's keys of the tile
      const int off = KS == 1 ? 0 : (int)(threadIdx.x >> 5) % KS * kKeys;
      TileMask mask = tiles.mask(t);
      if constexpr (KS > 1) {
        mask.j0 += off;
        mask.nk -= off;
        mask.full = mask.full ||
                    (!mask.causal && mask.window <= 0 && mask.nk >= kKeys);
      }
      if (KS == 1 || mask.nk > 0) {
        const T* ks = ring + (t % S) * 2 * L::kTile + off * L::kStride;
        float s[kKeys / 8][4];
        mma.scores(ks, s);
        sm.fold(s, mask, rp, scale_log2);
        mma.pv(ks + L::kTile, s, sm.o);
      }
    }
  }
}

// Whether Dp is one of the instantiated widths (the launch plan's d_pad).
inline bool valid_d_pad(int D, int Dp) {
  return D >= 1 && D <= Dp &&
         (Dp == 16 || Dp == 32 || Dp == 64 || Dp == 80 || Dp == 96 || Dp == 128);
}

// f(std::integral_constant<int, Dp>()) for a runtime Dp of valid_d_pad.
template <typename F>
int with_d_pad(int Dp, F f) {
  switch (Dp) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 128: return f(std::integral_constant<int, 128>());
  }
  return (int)cudaErrorInvalidValue;
}

// Every row 16-byte aligned for cp.async pieces.
inline bool rows_aligned(int D, size_t esize, const void* const* ptrs, int n) {
  if ((D * esize) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  return true;
}

// Dynamic shared memory of the ring, settable above the 48 KB default.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace mma_attn
