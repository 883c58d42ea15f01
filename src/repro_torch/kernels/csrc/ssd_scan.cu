// Mamba2 SSD chunked scan for Hopper (sm_90a): the scan of the mamba2
// prefill path (ssm_lm.prefill -> mamba_block_full -> ssd_chunked).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (body _ssd_kernel), and adds what the serving path needs beyond it: an
// initial state in and the final state out.
//
//   x      (B, L, H, P)   float32 or bfloat16
//   dt     (B, L, H)      float32
//   A      (H,)           float32, negative
//   Bm/Cm  (B, L, G, N)   x's type; head h reads group h / (H / G)
//   init   (B, H, N, P)   float32, or null for a zero state
//   y      (B, L, H, P)   x's type
//   final  (B, H, N, P)   float32, or null (not written)
//
// L is a multiple of the chunk length Q (at most 128).  Per chunk, with cum
// the inclusive cumsum of dt * A over the chunk and h the state carried in:
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i h
//   h'  = exp(cum_Q) h + sum_j B_j (dt_j exp(cum_Q - cum_j)) x_j
//
// All sums are f32.  exp(cum_i - cum_j) is evaluated only for j <= i: for
// j > i it is exp of a positive number that can overflow, and inf times a
// zero mask is NaN.
//
// Bound on the H100: bytes.  x, y, B, C, dt and the two f32 states move
// once; the products are about 4 N P + Q P flops per (position, head),
// 30 to 130 flops per byte moved at mamba2-130m's widths in bf16, below
// the ~295 at which the bf16 tensor cores would bound it.  At the serving
// prefill (one chunk) the call is a chain of dependent steps (load, four
// products, store) on one SM, so its latency, not either bound, sets the
// pace, and the design shortens and overlaps that chain:
//
//   * A split over P.  Each column slice h[:, p0:p0+16] of the state
//     evolves on its own, and y[..., p0:p0+16] reads only that slice and
//     x's, so the grid is (P / 16, H, B) with no merge across CTAs (four
//     times mamba2's 24 CTAs).  Each CTA recomputes the chunk's cumsum and
//     C.B^T; B and C are shared by the heads of a group, so the repeated
//     reads come from L2.  The plan (slice, stages, shared bytes) comes
//     from kernels/common.py::ssd_plan and is checked here.
//   * Products on the tensor cores, mma.sync, in f32 accuracy.  For bf16
//     inputs x, B and C are exact in bf16 and in TF32:
//       C.B^T  bf16 m16n8k16 with f32 accumulators (exact products), then
//              weighted by exp(cum_i - cum_j) dt_j in registers, j <= i;
//       C.h    TF32 m16n8k8, h (f32) split into a TF32 high part and
//              residual: two products; each row then times exp(cum_i);
//       att.x  att split, x exact: two products;
//       h'     exp(cum_Q) h + B^T (w x), w_j = dt_j exp(cum_Q - cum_j) on
//              x's side, split: two products.
//     For f32 inputs every product is 3xTF32 (mma_attention.cuh's split).
//     The high-part and residual products sum into separate accumulators,
//     so no accumulator waits on more than half the chain.  The tensor
//     cores' f32 accumulation does not round to nearest, so the f32 error
//     grows with the chunk count faster than a round-to-nearest sum's.
//   * Two roles, eight warps.  Within a chunk, y and the new state depend
//     only on the chunk's inputs and the state carried in, so they run side
//     by side: y warp w (of four) owns the 16-row chunk tile w (chunks of
//     up to 64 rows), or w and w + 4 with C.B^T in two segments of 64 keys
//     (up to 128 rows: a second instance, so that the serving chunk runs
//     straight-line code); state warp w
//     (of four) owns the 16-row state tiles w, w + 4, ..., two at a time
//     (sharing each step's w x split), reads them from the state carried
//     in and publishes their new values into the other of two shared
//     buffers, from which the y warps take the next chunk's C.h.
//     Each of the SM's four schedulers then holds two warps, which hide
//     some of each other's latency.
//   * The next chunk in flight.  x's slice, B, C and dt come in by
//     cp.async (16-byte pieces where rows allow, else through registers),
//     kept in the input type, into a two-stage ring: chunk c + 1 lands
//     while chunk c computes.  Where two stages do not fit (f32 inputs at
//     large Q N), one stage and a second barrier a chunk.  Q, N and the
//     slice pad to the fragment sizes with zeros written once, since
//     copies never touch the pads.
//   * One barrier a chunk: the cumsum is a warp scan (__shfl_up_sync) that
//     every warp takes for itself in log2 units (exp2f with log2(e)
//     folded in), and the two state buffers alternate, so the barrier that
//     lands chunk c also publishes chunk c - 1's state and frees its stage.
#include "mma_attention.cuh"

namespace ssd {

using mma_attn::allow_smem;
using mma_attn::cp_async16;
using mma_attn::cp_async_commit;
using mma_attn::cp_async_wait;
using mma_attn::cp_async_zfill;
using mma_attn::from_float;
using mma_attn::ldmatrix_x4;
using mma_attn::mma_bf16;
using mma_attn::mma_tf32;
using mma_attn::smem_u32;
using mma_attn::split_tf32;

constexpr int kPs = 16;         // columns of P a CTA
constexpr int kNB = kPs / 8;    // 8-column blocks of the slice
constexpr int kYWarps = 4;      // y warps: 16-row chunk tiles w, w + 4
constexpr int kStateWarps = 4;  // state warps: 16-row state tiles w, w + 4, ..
constexpr int kWarps = kYWarps + kStateWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 16 * kYWarps;  // chunk rows of one pass of the y
                                    // warps, keys of one C.B^T segment
constexpr int kMaxQ = 2 * kSeg;
constexpr int kHS = 24;      // floats a shared state row: 16 columns, and
                             // the B fragments' rows t4 * 24 hit distinct
                             // banks
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Dims {
  int B, L, H, G, N, P, Q;
};

// Shared layout (bytes) of one instance: ``stages`` stages, each B and C
// (Qp rows of Np elements plus 16 bytes), x's slice (Qp rows of 16
// elements plus a pad that spreads the fragment rows over the banks) and
// dt (Qp floats); then the two state buffers (Np rows of kHS floats); then
// each warp's log2 cumsum (y warps) or state weights (state warps), Qp
// floats.  Mirrored by kernels/common.py::ssd_plan.
struct Layout {
  int Qp, Np;  // Q and N padded to 16
  int ns, xs;  // elements a shared row of B / C and of x
  size_t c, x, dt, stage, h, cum, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int Q, int N, int stages) {
  Layout l;
  l.Qp = (Q + 15) / 16 * 16;
  l.Np = (N + 15) / 16 * 16;
  l.ns = l.Np + 16 / (int)sizeof(T);
  l.xs = kPs + (sizeof(T) == 4 ? 4 : 8);
  l.c = sizeof(T) * l.Qp * l.ns;  // B at offset 0
  l.x = l.c + sizeof(T) * l.Qp * l.ns;
  l.dt = l.x + sizeof(T) * l.Qp * l.xs;
  l.stage = l.dt + sizeof(float) * l.Qp;
  l.h = stages * l.stage;
  l.cum = l.h + sizeof(float) * 2 * l.Np * kHS;
  l.total = l.cum + sizeof(float) * kWarps * l.Qp;
  return l;
}

// A value of T as the bits of a TF32 operand: exact for bf16 (its f32 has
// 8 significant bits) and for f32 only after split_tf32.
__device__ __forceinline__ uint32_t tf32_bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v) << 16;
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// d += a . b over one m16n8k8 step in f32 accuracy: a and b given as (high
// part, residual) pairs, 3 TF32 products (the residual terms first).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0h,
                                     uint32_t b1h, uint32_t b0l, uint32_t b1l) {
  mma_tf32(d, al, b0h, b1h);
  mma_tf32(d, ah, b0l, b1l);
  mma_tf32(d, ah, b0h, b1h);
}

// s[n] = C_rows . B_j^T for the 8-key blocks n < nkb of this warp's 16
// chunk rows at sc and the keys at sb (row stride ns), over Np / 16 (bf16)
// or Np / 8 (f32) contraction steps.
template <int kB>
__device__ __forceinline__ void chunk_scores(const __nv_bfloat16* sc,
                                             const __nv_bfloat16* sb, int ns,
                                             int Np, int nkb,
                                             float (&s)[kB][4]) {
  const int lane = threadIdx.x & 31;
  // A: x4 matrices (rows +0, k +0), (rows +8, k +0), (rows +0, k +8),
  // (rows +8, k +8); B as mma_attention.cuh's scores: (keys +0, k +0),
  // (keys +0, k +8), (keys +8, k +0), (keys +8, k +8)
  const uint32_t abase = smem_u32(sc + (lane & 15) * ns + (lane >> 4) * 8);
  const uint32_t bbase =
      smem_u32(sb + ((lane >> 4) * 8 + (lane & 7)) * ns + ((lane >> 3) & 1) * 8);
  for (int kk = 0; kk < Np / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, abase + (uint32_t)kk * 32u);
#pragma unroll
    for (int n2 = 0; n2 < kB / 2; ++n2) {
      if (2 * n2 < nkb) {
        uint32_t b[4];
        ldmatrix_x4(b, bbase + (uint32_t)(n2 * 16 * ns + kk * 16) * 2u);
        mma_bf16(s[2 * n2], a, b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int kB>
__device__ __forceinline__ void chunk_scores(const float* sc, const float* sb,
                                             int ns, int Np, int nkb,
                                             float (&s)[kB][4]) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float* ca = sc + g * ns + t4;  // a0 = C[g][8k + t4]
  const float* kb = sb + g * ns + t4;  // b0 = B[8n + g][8k + t4]
  for (int kk = 0; kk < Np / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(ca[kk * 8], ah[0], al[0]);
    split_tf32(ca[8 * ns + kk * 8], ah[1], al[1]);
    split_tf32(ca[kk * 8 + 4], ah[2], al[2]);
    split_tf32(ca[8 * ns + kk * 8 + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kB; ++n) {
      if (n < nkb) {
        const float* kp = kb + n * 8 * ns + kk * 8;
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(kp[0], b0h, b0l);
        split_tf32(kp[4], b1h, b1l);
        mma3(s[n], ah, al, b0h, b1h, b0l, b1l);
      }
    }
  }
}

// The A fragment of C's rows g, g + 8 at step k (columns 8k + t4, + 4) as
// (high part, residual); a bf16 C is exact, its residual 0 (unused).
__device__ __forceinline__ void c_fragment(const __nv_bfloat16* ca, int ns,
                                           int k, uint32_t (&ah)[4],
                                           uint32_t (&)[4]) {
  ah[0] = tf32_bits(ca[8 * k]);
  ah[1] = tf32_bits(ca[8 * ns + 8 * k]);
  ah[2] = tf32_bits(ca[8 * k + 4]);
  ah[3] = tf32_bits(ca[8 * ns + 8 * k + 4]);
}
__device__ __forceinline__ void c_fragment(const float* ca, int ns, int k,
                                           uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(ca[8 * k], ah[0], al[0]);
  split_tf32(ca[8 * ns + 8 * k], ah[1], al[1]);
  split_tf32(ca[8 * k + 4], ah[2], al[2]);
  split_tf32(ca[8 * ns + 8 * k + 4], ah[3], al[3]);
}

// dh + dl += a . b with b exact for bf16 inputs (bits as given; a's split,
// 2 products) or split for f32 inputs (3 products): the high parts'
// product into dh, the residual terms into dl.
template <typename T>
__device__ __forceinline__ void mma_b(float (&dh)[4], float (&dl)[4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], T b0, T b1) {
  if constexpr (sizeof(T) == 2) {
    mma_tf32(dl, al, tf32_bits(b0), tf32_bits(b1));
    mma_tf32(dh, ah, tf32_bits(b0), tf32_bits(b1));
  } else {
    uint32_t b0h, b0l, b1h, b1l;
    split_tf32(b0, b0h, b0l);
    split_tf32(b1, b1h, b1l);
    mma_tf32(dl, al, b0h, b1h);
    mma_tf32(dl, ah, b0l, b1l);
    mma_tf32(dh, ah, b0h, b1h);
  }
}

// dh + dl += a . b with a exact for bf16 inputs (b's split, 2 products) or
// split for f32 inputs (3 products); b given as (high part, residual).
template <typename T>
__device__ __forceinline__ void mma_a(float (&dh)[4], float (&dl)[4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t b0h,
                                      uint32_t b1h, uint32_t b0l, uint32_t b1l) {
  if constexpr (sizeof(T) == 4) mma_tf32(dl, al, b0h, b1h);
  mma_tf32(dl, ah, b0l, b1l);
  mma_tf32(dh, ah, b0h, b1h);
}

template <int kN>
__device__ __forceinline__ void zero(float (&a)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// The y of one y warp's chunk rows i0 .. i0 + 15 (i0 < Q), from stage
// (sb, sc, sx, sd), this warp's log2 cumsum ``cum`` and the state carried
// in ``hin`` (Np rows of kHS floats):
//   att = (C B^T) exp2(cum_i - cum_j) dt_j, j <= i, else 0
//   y   = exp2(cum_i) (C h) + att x
// with the keys j <= i0 + 15 taken in kSegs segments of kSeg.
template <typename T, int kSegs>
__device__ __forceinline__ void chunk_y(const T* sb, const T* sc, const T* sx,
                                        const float* sd, const float* cum,
                                        const float* hin, T* y, int i0, int Q,
                                        int Np, int ns, int xs, int pv,
                                        size_t row_stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  // C h first: it needs neither the cumsum nor C.B^T
  float chh[kNB][4], chl[kNB][4];
  zero(chh);
  zero(chl);
  const float* hp0 = hin + t4 * kHS + g;  // b0 = h[8k + t4][8 nb + g]
  const T* ca = sc + (i0 + g) * ns + t4;
#pragma unroll 2
  for (int k = 0; k < Np / 8; ++k) {
    uint32_t ah[4], al[4];
    c_fragment(ca, ns, k, ah, al);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const float* hp = hp0 + 8 * k * kHS + 8 * nb;
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(hp[0], b0h, b0l);
      split_tf32(hp[4 * kHS], b1h, b1l);
      mma_a<T>(chh[nb], chl[nb], ah, al, b0h, b1h, b0l, b1l);
    }
  }

  const float ci[2] = {cum[i0 + g], cum[i0 + g + 8]};
  float axh[kNB][4], axl[kNB][4];
  zero(axh);
  zero(axl);
  for (int sg = 0; sg < kSegs; ++sg) {
    const int j0 = kSeg * sg;
    if (j0 >= i0 + 16) break;
    // 8-key blocks of this segment with a key j <= i0 + 15
    const int nkb = min(kSeg, i0 + 16 - j0) / 8;
    float att[kSeg / 8][4];
    zero(att);
    chunk_scores(sc + i0 * ns, sb + j0 * ns, ns, Np, nkb, att);
#pragma unroll
    for (int n = 0; n < kSeg / 8; ++n) {
      if (n < nkb) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + 8 * n + 2 * t4 + c;
          const float cj = cum[j], dj = sd[j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            att[n][e] = j <= i0 + g + 8 * r
                            ? att[n][e] * exp2f(ci[r] - cj) * dj : 0.f;
          }
        }
      }
    }

    // att x: the contraction index k of m16n8k8 maps to key 2k (k < 4) or
    // 2 (k - 4) + 1 of each 8-key block, so att's accumulator fragment is
    // its A fragment: b0 = x[8 n + 2 t4][8 nb + g], b1 = the next key
    const T* xb = sx + (j0 + 2 * t4) * xs + g;
#pragma unroll
    for (int n = 0; n < kSeg / 8; ++n) {
      if (n < nkb) {
        uint32_t ah[4], al[4];
        split_tf32(att[n][0], ah[0], al[0]);
        split_tf32(att[n][2], ah[1], al[1]);
        split_tf32(att[n][1], ah[2], al[2]);
        split_tf32(att[n][3], ah[3], al[3]);
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          const T* xp = xb + 8 * n * xs + 8 * nb;
          mma_b<T>(axh[nb], axl[nb], ah, al, xp[0], xp[xs]);
        }
      }
    }
  }
  const float ei[2] = {exp2f(ci[0]), exp2f(ci[1])};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = i0 + g + 8 * (e >> 1);
    if (i >= Q) continue;
    T* out = y + i * row_stride;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int p = 8 * nb + 2 * t4 + (e & 1);
      if (p < pv)
        out[p] = from_float<T>(ei[e >> 1] * (chh[nb][e] + chl[nb][e]) +
                               (axh[nb][e] + axl[nb][e]));
    }
  }
}

// State tiles mt and mt + kStateWarps (the second while < n_mt; rows
// 16 mt + g (+ 8), columns 8 nb + 2 t4 (+ 1)) of h' into ``hacc``, from
// the state carried in ``hin``; the two share each step's w x split:
//   h' = exp2(cq) h + B^T (w x),  A = B^T: a0 = B[8k + t4][16 mt + g],
//   a1 = column + 8, a2 / a3 = row + 4; b = (w x)[8k + t4][8 nb + g], + 4
template <typename T>
__device__ __forceinline__ void state_tiles(float (&hacc)[2][kNB][4],
                                            const T* sb, const T* sx,
                                            const float* wts, const float* hin,
                                            float decay, int mt, int n_mt,
                                            int Qp, int ns, int xs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float hl[2][kNB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    zero(hl[i]);
    const int row = 16 * (mt + kStateWarps * i) + g;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v =
            i == 0 || mt + kStateWarps < n_mt
                ? *reinterpret_cast<const float2*>(
                      hin + (row + 8 * hh) * kHS + 8 * nb + 2 * t4)
                : make_float2(0.f, 0.f);
        hacc[i][nb][2 * hh] = decay * v.x;
        hacc[i][nb][2 * hh + 1] = decay * v.y;
      }
  }
#pragma unroll 2
  for (int k = 0; k < Qp / 8; ++k) {
    const int j = 8 * k + t4;
    const float w0 = wts[j], w1 = wts[j + 4];
    uint32_t bh[kNB][2], bl[kNB][2];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      split_tf32(w0 * to_float(sx[j * xs + 8 * nb + g]), bh[nb][0], bl[nb][0]);
      split_tf32(w1 * to_float(sx[(j + 4) * xs + 8 * nb + g]), bh[nb][1],
                 bl[nb][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = mt + kStateWarps * i;
      if (m < n_mt) {
        const T* bp = sb + j * ns + 16 * m + g;
        uint32_t ah[4], al[4];
        if constexpr (sizeof(T) == 2) {
          ah[0] = tf32_bits(bp[0]);
          ah[1] = tf32_bits(bp[8]);
          ah[2] = tf32_bits(bp[4 * ns]);
          ah[3] = tf32_bits(bp[4 * ns + 8]);
        } else {
          split_tf32(bp[0], ah[0], al[0]);
          split_tf32(bp[8], ah[1], al[1]);
          split_tf32(bp[4 * ns], ah[2], al[2]);
          split_tf32(bp[4 * ns + 8], ah[3], al[3]);
        }
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          mma_a<T>(hacc[i][nb], hl[i][nb], ah, al, bh[nb][0], bh[nb][1],
                   bl[nb][0], bl[nb][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[i][nb][e] += hl[i][nb][e];
}

// ``vec``: bit 0, B and C rows go by 16-byte cp.async (N * sizeof(T) % 16
// == 0, aligned bases); bit 1, x's slice rows do (P * sizeof(T) % 16 == 0,
// aligned base).  ``stages``: 1 or 2 (the plan's).  ``kTiles``: 16-row
// chunk tiles a y warp, 1 for chunks of up to kSeg rows (straight-line
// code on the serving path), 2 up to kMaxQ.
template <typename T, int kTiles>
__global__ void __launch_bounds__(kThreads)
    ssd_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ init,
                   T* __restrict__ y, float* __restrict__ fin, Dims d,
                   int stages, int vec) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements a 16-byte piece
  constexpr int kScanRows = kTiles * kSeg / 32;  // chunk rows a lane scans
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout<T>(d.Q, d.N, stages);
  const int Q = d.Q, N = d.N, P = d.P, Qp = lay.Qp, Np = lay.Np;
  const int ns = lay.ns, xs = lay.xs;
  const int p0 = blockIdx.x * kPs;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int pv = min(kPs, P - p0);  // live columns of this slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int sw = warp - kYWarps;   // >= 0: a state warp
  const int n_mt = Np / 16;        // 16-row tiles of the state
  const float a2 = A[h] * kLog2e;  // cumsums in log2 units
  const size_t state0 = ((size_t)b * d.H + h) * N * P + p0;
  float* hs = reinterpret_cast<float*>(smem + lay.h);  // [2][Np][kHS]
  // this warp's log2 cumsum (y warp) or state weights (state warp)
  float* mine = reinterpret_cast<float*>(smem + lay.cum) + warp * Qp;

  const auto stage = [&](int s, T*& sb, T*& sc, T*& sx, float*& sd) {
    unsigned char* st = smem + s * lay.stage;
    sb = reinterpret_cast<T*>(st);
    sc = reinterpret_cast<T*>(st + lay.c);
    sx = reinterpret_cast<T*>(st + lay.x);
    sd = reinterpret_cast<float*>(st + lay.dt);
  };

  // start copying chunk c into stage s
  const auto issue = [&](int c, int s) {
    T *sb, *sc, *sx;
    float* sd;
    stage(s, sb, sc, sx, sd);
    const size_t row0 = (size_t)b * d.L + (size_t)c * Q;  // (b, l0) in (B, L)
    if (vec & 1) {
      const int np = N / kPer;
      for (int e = threadIdx.x; e < Q * np; e += kThreads) {
        const int r = e / np, i = e - r * np;
        const size_t src = ((row0 + r) * d.G + grp) * N + i * kPer;
        cp_async16(sb + r * ns + i * kPer, Bm + src);
        cp_async16(sc + r * ns + i * kPer, Cm + src);
      }
    } else {
      for (int e = threadIdx.x; e < Q * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        const size_t src = ((row0 + r) * d.G + grp) * N + n;
        sb[r * ns + n] = Bm[src];
        sc[r * ns + n] = Cm[src];
      }
    }
    if (vec & 2) {
      const int np = pv / kPer;
      for (int e = threadIdx.x; e < Q * np; e += kThreads) {
        const int r = e / np, i = e - r * np;
        cp_async16(sx + r * xs + i * kPer,
                   x + ((row0 + r) * d.H + h) * P + p0 + i * kPer);
      }
    } else {
      for (int e = threadIdx.x; e < Q * pv; e += kThreads) {
        const int r = e / pv, p = e - r * pv;
        sx[r * xs + p] = x[((row0 + r) * d.H + h) * P + p0 + p];
      }
    }
    for (int r = threadIdx.x; r < Q; r += kThreads)
      cp_async_zfill(sd + r, dt + (row0 + r) * d.H + h, 4, 4);
  };

  const int n_chunks = d.L / Q;
  issue(0, 0);
  cp_async_commit();

  // zero the pads of every stage once: copies write rows < Q, columns < N
  // (B, C) and < pv (x) only
  {
    const T z = from_float<T>(0.f);
    for (int s = 0; s < stages; ++s) {
      T *sb, *sc, *sx;
      float* sd;
      stage(s, sb, sc, sx, sd);
      for (int e = threadIdx.x; e < (Qp - Q) * Np; e += kThreads) {
        const int r = Q + e / Np, c = e % Np;
        sb[r * ns + c] = z;
        sc[r * ns + c] = z;
      }
      for (int e = threadIdx.x; e < Q * (Np - N); e += kThreads) {
        const int r = e / (Np - N), c = N + e % (Np - N);
        sb[r * ns + c] = z;
        sc[r * ns + c] = z;
      }
      for (int e = threadIdx.x; e < (Qp - Q) * kPs; e += kThreads)
        sx[(Q + e / kPs) * xs + e % kPs] = z;
      for (int e = threadIdx.x; e < Q * (kPs - pv); e += kThreads)
        sx[e / (kPs - pv) * xs + pv + e % (kPs - pv)] = z;
      for (int r = Q + threadIdx.x; r < Qp; r += kThreads) sd[r] = 0.f;
    }
  }
  // the state carried into chunk 0, padded with zeros to Np rows, 16 columns
  for (int e = threadIdx.x; e < Np * kPs; e += kThreads) {
    const int n = e / kPs, p = e % kPs;
    hs[n * kHS + p] = init != nullptr && n < N && p < pv
                          ? init[state0 + (size_t)n * P + p]
                          : 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int s = stages == 2 ? c & 1 : 0;
    const float* hin = hs + (c & 1) * Np * kHS;
    float* hout = hs + ((c & 1) ^ 1) * Np * kHS;
    cp_async_wait<0>();
    // chunk c is in (at c == 0 with the pads and the initial state); every
    // warp is done with chunk c - 1, its stage and the state it read
    __syncthreads();
    if (stages == 2 && c + 1 < n_chunks) issue(c + 1, s ^ 1);
    cp_async_commit();
    T *sb, *sc, *sx;
    float* sd;
    stage(s, sb, sc, sx, sd);

    // this warp's log2 cumsum: lane l holds rows kScanRows l + r
    float run = 0.f, pre[kScanRows];
#pragma unroll
    for (int r = 0; r < kScanRows; ++r) {
      const int row = kScanRows * lane + r;
      run += row < Qp ? sd[row] * a2 : 0.f;
      pre[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
#pragma unroll
    for (int r = 0; r < kScanRows; ++r) pre[r] += incl - run;
    // the chunk's total: dt is 0 past row Q - 1 (the pads)
    const float cq = __shfl_sync(kFull, incl, 31);

    if (sw < 0) {
#pragma unroll
      for (int r = 0; r < kScanRows; ++r)
        if (kScanRows * lane + r < Qp) mine[kScanRows * lane + r] = pre[r];
      __syncwarp();
      for (int t = 0; t < kTiles; ++t) {
        const int i0 = 16 * (warp + kYWarps * t);
        if (i0 < Q)
          chunk_y<T, kTiles>(
              sb, sc, sx, sd, mine, hin,
              y + (((size_t)b * d.L + (size_t)c * Q) * d.H + h) * P + p0, i0,
              Q, Np, ns, xs, pv, (size_t)d.H * P);
      }
    } else {
      // the weights w_j = dt_j exp(cum_Q - cum_j), 0 past Q
#pragma unroll
      for (int r = 0; r < kScanRows; ++r) {
        const int row = kScanRows * lane + r;
        if (row < Qp) mine[row] = row < Q ? sd[row] * exp2f(cq - pre[r]) : 0.f;
      }
      __syncwarp();
      const float decay = exp2f(cq);
      for (int mt = sw; mt < n_mt; mt += 2 * kStateWarps) {
        float hacc[2][kNB][4];
        state_tiles<T>(hacc, sb, sx, mine, hin, decay, mt, n_mt, Qp, ns, xs);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = mt + kStateWarps * i;
          if (m >= n_mt) continue;
          // publish h' for the y warps' next C.h (the other buffer)
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(
                  hout + (16 * m + g + 8 * hh) * kHS + 8 * nb + 2 * t4) =
                  make_float2(hacc[i][nb][2 * hh], hacc[i][nb][2 * hh + 1]);
          if (fin != nullptr && c == n_chunks - 1) {
#pragma unroll
            for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = 16 * m + g + 8 * (e >> 1);
                const int p = 8 * nb + 2 * t4 + (e & 1);
                if (n < N && p < pv)
                  fin[state0 + (size_t)n * P + p] = hacc[i][nb][e];
              }
          }
        }
      }
    }
    if (stages == 1 && c + 1 < n_chunks) {
      __syncthreads();  // every warp is done with the one stage
      issue(c + 1, 0);
      cp_async_commit();
    }
  }
}

template <typename T, int kTiles>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* init, void* y, float* fin,
           const Dims& d, int stages, int smem, cudaStream_t stream) {
  if ((size_t)smem != layout<T>(d.Q, d.N, stages).total)
    return (int)cudaErrorInvalidValue;
  const auto kernel = ssd_mma_kernel<T, kTiles>;
  const int err = allow_smem(kernel, (size_t)smem);
  if (err != 0) return err;
  const void* bc[] = {Bm, Cm};
  const void* xr[] = {x};
  const int vec = mma_attn::rows_aligned(d.N, sizeof(T), bc, 2) |
                  mma_attn::rows_aligned(d.P, sizeof(T), xr, 1) << 1;
  kernel<<<dim3((d.P + kPs - 1) / kPs, d.H, d.B), kThreads, smem, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, init, (T*)y, fin, d,
      stages, vec);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16; Ps (columns of P
// per CTA, 16), stages (1 or 2) and smem: the launch plan (kernels/
// common.py::ssd_plan), refused unless this file instantiates it with
// those bytes.  init and final may be null.  Returns a cudaError_t (0 =
// launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init,
                        void* y, void* final_state, int B, int L, int H,
                        int G, int N, int P, int Q, int dtype, int Ps,
                        int stages, int smem, void* stream) {
  using namespace ssd;
  if (B < 1 || L < 1 || H < 1 || G < 1 || N < 1 || P < 1 || Q < 1 ||
      B > 65535 || H > 65535 || L % Q != 0 || H % G != 0 || Q > kMaxQ ||
      Ps != kPs || (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  const Dims d{B, L, H, G, N, P, Q};
  cudaStream_t st = (cudaStream_t)stream;
  const float* dtf = (const float*)dt;
  const float* Af = (const float*)A;
  const float* in = (const float*)init;
  float* out = (float*)final_state;
  const bool two = Q > kSeg;  // two chunk tiles a y warp
  if (dtype == 0)
    return two ? launch<float, 2>(x, dtf, Af, Bm, Cm, in, y, out, d, stages,
                                  smem, st)
               : launch<float, 1>(x, dtf, Af, Bm, Cm, in, y, out, d, stages,
                                  smem, st);
  if (dtype == 1)
    return two ? launch<__nv_bfloat16, 2>(x, dtf, Af, Bm, Cm, in, y, out, d,
                                          stages, smem, st)
               : launch<__nv_bfloat16, 1>(x, dtf, Af, Bm, Cm, in, y, out, d,
                                          stages, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
