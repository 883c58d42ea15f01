// Paged prefill-chunk attention for Hopper (sm_90a): the C queries of one
// prompt chunk per sequence attend the sequence's prefix, read in place
// from its KV pages, and then the chunk's own keys causally.
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/paged_prefill_attention.py::paged_prefill_attention and
// ::paged_prefill_attention_quant (its int8 twin).
//
//   q            (B, H, C, D)       float32 or bfloat16; row c sits at
//                                   absolute position starts[b] + c
//   k/v_pages    (N, KVH, bs, D)    same type as q, or int8 (the quant twin)
//   k/v_scale    (N, KVH, bs)       quant twin only: one scale per row, in
//                                   q's type; a row is f32(x) * f32(scale)
//   chunk_k/v    (B, KVH, C, D)     the chunk's own keys and values, q's
//                                   type in both twins (the fresh float
//                                   projections, never the int8 pages)
//   block_table  (B, nb) int32      ids >= N are sentinels, clamped
//   starts       (B,) int32         tokens already in pages
//   valid        (B,) int32         real tokens in the chunk (0 = inactive)
//   out          (B, H, C, D)       q's type
//
// Every prefix position < starts[b] is visible to every chunk query; chunk
// key j is visible to query c iff j <= c and j < valid[b].  Rows at or past
// valid[b] are garbage the caller ignores; q tiles that start at or past
// valid[b] (all of a valid == 0 row) write 0 and read nothing.
//
// Bound on the H100: at long context the products, 4 flops per (query
// head, visible key, dimension), against the live prefix KV (2 *
// sum_b starts[b] * KVH * D * sizeof(T)) plus q, the chunk k/v and the
// output moved once; at the engine's short chunks the bytes, and in
// practice the latency of one CTA's key loop.  One CTA per (b, kv_head, q
// tile) holds the GQA group's queries of a tile of chunk positions (group
// * tile <= 64 rows), so each live prefix page is read once per KV head
// and q tile, never densified into a gathered copy, and both segments
// fold into one online softmax.  The float kernel runs the tensor-core
// core of mma_attention.cuh: 64-key tiles arrive by cp.async into a ring
// of shared stages (the paged source looks each row's page up in the
// block table a tile ahead and clamps it into the pool before forming an
// address), and both products run as mma.sync (bf16, or 3xTF32 for f32)
// with the scores, the probabilities and the output in registers.  Only
// tiles that cross the prefix end or the chunk's causal edge evaluate a
// per-element mask.  The launch plan (positions per tile, padded D,
// shared bytes) comes from the Python wrapper
// (kernels/common.py::attention_plan) and is checked here.  The int8 twin
// still runs the CUDA-core body of paged_attention.cuh, dequantizing each
// page row as it lands in its f32 shared tile.
#include "mma_attention.cuh"
#include "paged_attention.cuh"

namespace paged {

// The int8 twin's body (CUDA cores, 32-key tiles; KV = Int8KV<S>).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, KV kv,
                         const T* __restrict__ chunk_k,
                         const T* __restrict__ chunk_v,
                         const int* __restrict__ block_table,
                         const int* __restrict__ starts,
                         const int* __restrict__ valid, T* __restrict__ out,
                         int H, int KVH, int C, int D, int N, int bs, int nb,
                         int TQ) {
  extern __shared__ float smem[];
  const int c0 = blockIdx.x * TQ;  // first chunk position of this q tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = G * TQ;  // row r: head kvh * G + r / TQ, position c0 + r % TQ
  const int vd = min(valid[b], C);
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;

  if (c0 >= vd) {
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D;
      const int c = c0 + r % TQ;
      if (c < C)
        out[((head0 + r / TQ) * C + c) * D + e % D] = from_float<T>(0.f);
    }
    return;
  }

  const Shared sh = carve(smem, rows, D);
  const float scale = 1.f / sqrtf((float)D);
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D;
    const int c = c0 + r % TQ;
    sh.q[e] = c < C ? to_float(q[((head0 + r / TQ) * C + c) * D + e % D]) * scale
                    : 0.f;
  }
  float acc[kAcc];
  init_rows(sh, rows, acc);

  // the prefix: chunk queries all sit at positions >= starts[b], so every
  // live prefix key is visible to every row
  const int n_prefix = min(starts[b], nb * bs);
  const int* bt_row = block_table + (size_t)b * nb;
  const auto all = [](int, int) { return true; };
  for (int k0 = 0; k0 < n_prefix; k0 += kTileK) {
    const int nk = min(kTileK, n_prefix - k0);
    load_page_tile(sh, kv, bt_row, kvh, KVH, bs, D, N, k0, nk);
    fold_tile(sh, rows, D, nk, all, acc);
  }

  // the chunk's own keys, causal within the chunk and below valid[b]; keys
  // past this tile's last query are invisible to all of its rows
  const int n_chunk = min(vd, min(c0 + TQ, C));
  const FloatKV<T> chunk{chunk_k, chunk_v};
  const size_t row0 = ((size_t)b * KVH + kvh) * C;
  for (int j0 = 0; j0 < n_chunk; j0 += kTileK) {
    const int nk = min(kTileK, n_chunk - j0);
    load_row_tile(sh, chunk, row0, D, j0, nk);
    const auto causal = [=](int r, int j) {
      return j0 + j <= c0 + r % TQ && j0 + j < vd;
    };
    fold_tile(sh, rows, D, nk, causal, acc);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < rows * D) {
      const int r = idx / D;
      const int c = c0 + r % TQ;
      if (c < C)
        out[((head0 + r / TQ) * C + c) * D + idx % D] =
            from_float<T>(acc[i] / fmaxf(sh.l[r], 1e-20f));
    }
  }
}

template <typename T, typename KV>
int launch(const void* q, KV kv, const void* chunk_k, const void* chunk_v,
           const int* block_table, const int* starts, const int* valid,
           void* out, int B, int H, int KVH, int C, int D, int N, int bs,
           int nb, cudaStream_t stream) {
  // query positions per tile: the GQA group times TQ fills <= kMaxRows rows
  const int fit = kMaxRows / (H / KVH);
  const int TQ = C < fit ? C : fit;
  const size_t smem = shared_bytes((H / KVH) * TQ, D);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((C + TQ - 1) / TQ, KVH, B);
  paged_prefill_kernel<T, KV><<<grid, kThreads, smem, stream>>>(
      (const T*)q, kv, (const T*)chunk_k, (const T*)chunk_v, block_table,
      starts, valid, (T*)out, H, KVH, C, D, N, bs, nb, TQ);
  return (int)cudaGetLastError();
}

inline bool valid_dims(int B, int H, int KVH, int C, int D, int N, int bs,
                       int nb) {
  return valid_heads(B, H, KVH, D) && C >= 1 && N >= 1 && bs >= 1 && nb >= 1;
}

}  // namespace paged

namespace mma_attn {

// The key tiles of one CTA: tp tiles of the page-resident prefix, then
// the chunk's own keys.
template <typename T>
struct PrefillTiles {
  const T* kp;
  const T* vp;
  const T* ck;
  const T* cv;
  const int* bt_row;
  int n, tp, n_prefix, n_chunk, c0, N, KVH, kvh, bs;
  size_t row0;  // the chunk's first row of (b, kvh)

  __device__ __forceinline__ int nk(int t) const {
    return t < tp ? min(kTileN, n_prefix - t * kTileN)
                  : min(kTileN, n_chunk - (t - tp) * kTileN);
  }
  // position p lives in page bt_row[p / bs], row p % bs; the page id is
  // clamped into the pool before any address is formed
  __device__ __forceinline__ size_t row(int t, int j) const {
    if (t >= tp) return row0 + (t - tp) * kTileN + j;
    const int pos = t * kTileN + j;
    int page = bt_row[pos / bs];
    page = page < 0 ? 0 : (page >= N ? N - 1 : page);
    return ((size_t)page * KVH + kvh) * bs + pos % bs;
  }
  __device__ __forceinline__ const T* k(int t) const { return t < tp ? kp : ck; }
  __device__ __forceinline__ const T* v(int t) const { return t < tp ? vp : cv; }
  __device__ __forceinline__ TileMask mask(int t) const {
    const int n_k = nk(t);
    if (t < tp) return TileMask{0, n_k, 0, 0, n_k == kTileN};
    const int j0 = (t - tp) * kTileN;
    return TileMask{j0, n_k, 1, 0, n_k == kTileN && j0 + kTileN - 1 <= c0};
  }
};

template <typename T, int Dp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    prefill_mma_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const T* __restrict__ chunk_k,
                       const T* __restrict__ chunk_v,
                       const int* __restrict__ block_table,
                       const int* __restrict__ starts,
                       const int* __restrict__ valid, T* __restrict__ out,
                       int H, int KVH, int C, int D, int N, int bs, int nb,
                       int TQ, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.x * TQ;  // first chunk position of this q tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = G * TQ;  // row r: head kvh * G + r / TQ, position c0 + r % TQ
  const int vd = min(valid[b], C);
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;

  if (c0 >= vd) {
    const T z = from_float<T>(0.f);
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D;
      const int c = c0 + r % TQ;
      if (c < C) out[((head0 + r / TQ) * C + c) * D + e % D] = z;
    }
    return;
  }

  const RowPair rp(head0, rows, TQ, c0, C);
  Mma<T, Dp> mma;
  mma.load_q(reinterpret_cast<uint32_t*>(smem_raw + Layout<T, Dp>::kRing),
             rp.live[0] ? q + (rp.head[0] * C + rp.pos[0]) * D : nullptr,
             rp.live[1] ? q + (rp.head[1] * C + rp.pos[1]) * D : nullptr, D);
  Softmax<Dp> sm;

  // the prefix: chunk queries all sit at positions >= starts[b], so every
  // live prefix key is visible to every row; then the chunk's own keys,
  // causal and below valid[b] (keys past this tile's last query are
  // invisible to all of its rows)
  PrefillTiles<T> tiles;
  tiles.kp = k_pages;
  tiles.vp = v_pages;
  tiles.ck = chunk_k;
  tiles.cv = chunk_v;
  tiles.bt_row = block_table + (size_t)b * nb;
  tiles.n_prefix = min(starts[b], nb * bs);
  tiles.n_chunk = min(vd, min(c0 + TQ, C));
  tiles.tp = (tiles.n_prefix + kTileN - 1) / kTileN;
  tiles.n = tiles.tp + (tiles.n_chunk + kTileN - 1) / kTileN;
  tiles.c0 = c0;
  tiles.N = N;
  tiles.KVH = KVH;
  tiles.kvh = kvh;
  tiles.bs = bs;
  tiles.row0 = ((size_t)b * KVH + kvh) * C;
  key_loop<T, Dp>(reinterpret_cast<T*>(smem_raw), tiles, mma, sm, rp,
                  kLog2e / sqrtf((float)D), D, vec,
                  16 * (int)(threadIdx.x >> 5) < rows);

  T* const dst[2] = {rp.live[0] ? out + (rp.head[0] * C + rp.pos[0]) * D : nullptr,
                     rp.live[1] ? out + (rp.head[1] * C + rp.pos[1]) * D : nullptr};
  sm.write(dst, D);
}

// Launch the float kernel with the wrapper's plan (TQ positions per tile,
// Dp, smem bytes); a plan this file does not instantiate, or whose bytes
// differ from the ring's, is refused.
template <typename T>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const void* chunk_k, const void* chunk_v,
                   const int* block_table, const int* starts,
                   const int* valid, void* out, int B, int H, int KVH, int C,
                   int D, int N, int bs, int nb, int TQ, int Dp, int smem,
                   cudaStream_t stream) {
  if (TQ < 1 || (H / KVH) * TQ > kRows || !valid_d_pad(D, Dp))
    return (int)cudaErrorInvalidValue;
  const void* rows[] = {k_pages, v_pages, chunk_k, chunk_v};
  const int vec = rows_aligned(D, sizeof(T), rows, 4);
  return with_d_pad(Dp, [&](auto dp) {
    constexpr int kDp = decltype(dp)::value;
    if ((size_t)smem != Layout<T, kDp>::kSmem) return (int)cudaErrorInvalidValue;
    const int err = allow_smem(prefill_mma_kernel<T, kDp>, (size_t)smem);
    if (err != 0) return err;
    const dim3 grid((C + TQ - 1) / TQ, KVH, B);
    prefill_mma_kernel<T, kDp><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages, (const T*)chunk_k,
        (const T*)chunk_v, block_table, starts, valid, (T*)out, H, KVH, C, D,
        N, bs, nb, TQ, vec);
    return (int)cudaGetLastError();
  });
}

}  // namespace mma_attn

// dtype: 0 = float32, 1 = bfloat16; TQ, Dp, smem: the launch plan
// (kernels/common.py::attention_plan).  Returns a cudaError_t (0 =
// launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* chunk_k, const void* chunk_v, const void* block_table,
    const void* starts, const void* valid, void* out, int B, int H, int KVH,
    int C, int D, int N, int bs, int nb, int dtype, int TQ, int Dp, int smem,
    void* stream) {
  if (!paged::valid_dims(B, H, KVH, C, D, N, bs, nb))
    return (int)cudaErrorInvalidValue;
  const int* bt = (const int*)block_table;
  const int* st = (const int*)starts;
  const int* vd = (const int*)valid;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return mma_attn::launch_prefill<float>(q, k_pages, v_pages, chunk_k,
                                           chunk_v, bt, st, vd, out, B, H,
                                           KVH, C, D, N, bs, nb, TQ, Dp, smem,
                                           s);
  if (dtype == 1)
    return mma_attn::launch_prefill<__nv_bfloat16>(
        q, k_pages, v_pages, chunk_k, chunk_v, bt, st, vd, out, B, H, KVH, C,
        D, N, bs, nb, TQ, Dp, smem, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pages, float chunk k/v; dtype (of q, the scales, the chunk and out):
// 0 = float32, 1 = bfloat16.
extern "C" int paged_prefill_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* chunk_k,
    const void* chunk_v, const void* block_table, const void* starts,
    const void* valid, void* out, int B, int H, int KVH, int C, int D, int N,
    int bs, int nb, int dtype, void* stream) {
  using namespace paged;
  if (!valid_dims(B, H, KVH, C, D, N, bs, nb))
    return (int)cudaErrorInvalidValue;
  const int* bt = (const int*)block_table;
  const int* st = (const int*)starts;
  const int* vd = (const int*)valid;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* kq = (const int8_t*)k_pages;
  const int8_t* vq = (const int8_t*)v_pages;
  if (dtype == 0)
    return launch<float>(
        q,
        Int8KV<float>{kq, vq, (const float*)k_scale, (const float*)v_scale},
        chunk_k, chunk_v, bt, st, vd, out, B, H, KVH, C, D, N, bs, nb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        q,
        Int8KV<__nv_bfloat16>{kq, vq, (const __nv_bfloat16*)k_scale,
                              (const __nv_bfloat16*)v_scale},
        chunk_k, chunk_v, bt, st, vd, out, B, H, KVH, C, D, N, bs, nb, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
