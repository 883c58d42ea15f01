// The CUDA-core body of the one kernel left on it: the int8-KV twin of
// paged prefill (paged_prefill_attention.cu).  Every decode kernel and the
// float prefill and flash kernels run on the tensor cores
// (mma_attention.cuh, decode_mma.cuh); the int8 decode twins left this
// file for decode_mma.cuh's int8 sources, and write_rows, which only they
// used, went with them.
//
// The kernel runs one CTA over a set of query rows that share one KV head
// (the GQA group times a tile of chunk positions) and folds key tiles of
// kTileK keys into an f32 online softmax:
//
//   scores  s[r][j] = (q[r] / sqrt(D)) . k[j]          (masked -> p = 0)
//   m_new = max(m, max_j s),  p = exp(s - m_new),  alpha = exp(m - m_new)
//   l = l * alpha + sum_j p,  acc[r][:] = acc[r][:] * alpha + sum_j p[j] v[j][:]
//
// and writes acc / max(l, 1e-20), so a row that saw no key writes 0 (the
// TPU kernels' denominator floor).  The key tile lives in shared memory
// as f32, padded by one column so that the 32 lanes of a warp, each on
// its own key, read 32 distinct banks.  Accumulators stay in registers:
// thread t owns the output elements t, t + kThreads, ... of the
// (rows x D) tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;  // keys per tile: one per lane in the row reductions
constexpr int kMaxRows = 64;
constexpr int kMaxD = 128;
constexpr int kAcc = kMaxRows * kMaxD / kThreads;
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Shared {
  float* q;      // rows x D, pre-scaled by 1/sqrt(D)
  float* k;      // kTileK x (D + 1)
  float* v;      // kTileK x D
  float* s;      // rows x kTileK: scores, then probabilities
  float* m;      // rows: running max
  float* l;      // rows: running denominator
  float* alpha;  // rows: rescale factor of the current tile
};

inline size_t shared_bytes(int rows, int D) {
  return sizeof(float) * ((size_t)rows * D + (size_t)kTileK * (D + 1) +
                          (size_t)kTileK * D + (size_t)rows * kTileK +
                          3 * (size_t)rows);
}

__device__ __forceinline__ Shared carve(float* base, int rows, int D) {
  Shared sh;
  sh.q = base;
  sh.k = sh.q + rows * D;
  sh.v = sh.k + kTileK * (D + 1);
  sh.s = sh.v + kTileK * D;
  sh.m = sh.s + rows * kTileK;
  sh.l = sh.m + rows;
  sh.alpha = sh.l + rows;
  return sh;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void init_rows(const Shared& sh, int rows,
                                          float (&acc)[kAcc]) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    sh.m[r] = kNegInf;
    sh.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
}

// Key/value sources.  A row is one (page or chunk, KV head, position)
// of D elements, addressed by its flat index; key(row, d) / value(row, d)
// return element d as f32.  The loaders below are templated on the source,
// so the int8 prefix and the float chunk share one tile loop.

// Rows stored in the compute type T (float32 or bfloat16).
template <typename T>
struct FloatKV {
  const T* k;
  const T* v;
  __device__ __forceinline__ float key(size_t row, int d, int D) const {
    return to_float(k[row * D + d]);
  }
  __device__ __forceinline__ float value(size_t row, int d, int D) const {
    return to_float(v[row * D + d]);
  }
};

// int8 rows with one scale per row, stored in the compute type S:
// element = f32(x) * f32(scale), dequantized as the tile is loaded, so
// device memory is read as int8 payload plus scales.
template <typename S>
struct Int8KV {
  const int8_t* k;
  const int8_t* v;
  const S* k_scale;
  const S* v_scale;
  __device__ __forceinline__ float key(size_t row, int d, int D) const {
    return (float)k[row * D + d] * to_float(k_scale[row]);
  }
  __device__ __forceinline__ float value(size_t row, int d, int D) const {
    return (float)v[row * D + d] * to_float(v_scale[row]);
  }
};

// Keys and values at logical positions [k0, k0 + nk) of one sequence,
// read in place from its pages: position p lives in page bt_row[p / bs],
// row p % bs.  The page id is clamped into the pool before any address is
// formed, so a sentinel entry (>= N) can never fault; callers only ask
// for live positions, whose pages are real.
template <typename KV>
__device__ void load_page_tile(const Shared& sh, const KV& kv,
                               const int* __restrict__ bt_row, int kvh,
                               int KVH, int bs, int D, int N, int k0, int nk) {
  for (int e = threadIdx.x; e < nk * D; e += kThreads) {
    const int j = e / D;
    const int d = e - j * D;
    const int pos = k0 + j;
    int page = bt_row[pos / bs];
    page = page < 0 ? 0 : (page >= N ? N - 1 : page);
    const size_t row = ((size_t)page * KVH + kvh) * bs + pos % bs;
    sh.k[j * (D + 1) + d] = kv.key(row, d, D);
    sh.v[j * D + d] = kv.value(row, d, D);
  }
}

// Rows [j0, j0 + nk) of one contiguous (rows, D) slice whose first row has
// flat index row0: a prefill chunk's own keys.
template <typename KV>
__device__ void load_row_tile(const Shared& sh, const KV& kv, size_t row0,
                              int D, int j0, int nk) {
  for (int e = threadIdx.x; e < nk * D; e += kThreads) {
    const int j = e / D;
    const int d = e - j * D;
    const size_t row = row0 + j0 + j;
    sh.k[j * (D + 1) + d] = kv.key(row, d, D);
    sh.v[j * D + d] = kv.value(row, d, D);
  }
}

// Fold the nk keys now in sh.k / sh.v into the running softmax of `rows`
// query rows.  visible(r, j) says whether row r may attend key j of the
// tile.  Ends with a barrier, so the caller may load the next tile.
template <typename Visible>
__device__ void fold_tile(const Shared& sh, int rows, int D, int nk,
                          Visible visible, float (&acc)[kAcc]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();  // the tile loads are complete
  for (int idx = tid; idx < rows * kTileK; idx += kThreads) {
    const int r = idx / kTileK;
    const int j = idx - r * kTileK;
    float sc = kNegInf;
    if (j < nk && visible(r, j)) {
      const float* qr = sh.q + r * D;
      const float* kj = sh.k + j * (D + 1);
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], kj[d], a);
      sc = a;
    }
    sh.s[idx] = sc;
  }
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    const float sc = sh.s[r * kTileK + lane];
    const float m_prev = sh.m[r];
    const float m_new = fmaxf(m_prev, warp_max(sc));
    const float p = sc > 0.5f * kNegInf ? expf(sc - m_new) : 0.f;
    const float tot = warp_sum(p);
    sh.s[r * kTileK + lane] = p;
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      sh.alpha[r] = a;
      sh.l[r] = sh.l[r] * a + tot;
      sh.m[r] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < rows * D) {
      const int r = idx / D;
      const int d = idx - r * D;
      const float* pr = sh.s + r * kTileK;
      float a = acc[i] * sh.alpha[r];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], sh.v[j * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();  // sh.k / sh.v / sh.s may be overwritten now
}

// Shape checks of the C entry point.
inline bool valid_heads(int B, int H, int KVH, int D) {
  return B >= 1 && KVH >= 1 && H % KVH == 0 && H / KVH <= kMaxRows &&
         D >= 1 && D <= kMaxD;
}

}  // namespace paged
