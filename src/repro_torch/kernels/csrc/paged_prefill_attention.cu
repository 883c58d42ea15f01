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
// valid[b] follow the same rule (an MoE layer routes them, so they must be
// the plain version's) up to the end of the reference kernel's q tile that
// holds row valid[b] - 1 (``qt`` rows a tile, from the wrapper's
// ``reference_q_tile``); every row from there on, all of a valid == 0 row,
// is written 0.  Those zeros follow the reference's tiling, not this
// kernel's: a CUDA q tile may hold rows on both sides of that end.
//
// Bound on the H100: at long context the products, 4 flops per (query
// head, visible key, dimension), against the live prefix KV (2 *
// sum_b starts[b] * KVH * D * sizeof(T), or D + sizeof(T) bytes a row in
// int8) plus q, the chunk k/v and the output moved once; at the engine's
// short chunks the bytes, and in practice the latency of one CTA's key
// loop.  One CTA per (b, kv_head, q tile) holds the GQA group's queries of
// a tile of chunk positions (group * tile <= 64 rows), so each live prefix
// page is read once per KV head and q tile, never densified into a
// gathered copy, and both segments fold into one online softmax.  Both
// twins run the tensor-core core of mma_attention.cuh: 64-key tiles arrive
// by cp.async into a ring of shared stages (the paged source looks each
// row's page up in the block table a tile ahead and clamps it into the
// pool before forming an address), and both products run as mma.sync
// (bf16, or 3xTF32 for f32) with the scores, the probabilities and the
// output in registers.  Only tiles that cross the prefix end or the
// chunk's causal edge evaluate a per-element mask.
//
// The float kernel runs prefix and chunk tiles through one key_loop.  The
// int8 twin runs its prefix through int8_key_loop (int8 rows and their
// scales by cp.async, converted exactly into one bf16 / f32 tile pair, the
// k-scales on the scores and the v-scales on the probabilities), then,
// once every warp is done with that ring, the chunk's float tiles through
// key_loop into the same softmax state.  The two rings overlap; in f32,
// q's TF32 parts sit past the larger of them.  The launch plan (positions
// per tile, padded D, shared bytes) comes from the Python wrapper
// (kernels/common.py::attention_plan, with ``quant`` for the twin) and is
// checked here.
#include "mma_attention.cuh"

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

// The int8 twin's prefix tiles: PrefillTiles' page lookup over the int8
// pages, every tile a prefix tile (tp == n), with the scale pages at the
// same row index (int8_key_loop reads ``ks`` / ``vs``).
template <typename T>
struct PrefillInt8Tiles : PrefillTiles<int8_t> {
  const T* ks;
  const T* vs;
};

// Shared memory of the int8 twin: the int8 prefix ring (Int8Layout) and,
// once every warp is done with it, the chunk's float ring (Layout) from
// the same base; q's TF32 parts (f32) past the larger of the two, where
// neither loop writes.  kRing is their offset.
template <typename T, int Dp>
struct PrefillInt8Layout {
  static constexpr size_t kRing = Layout<T, Dp>::kRing > Int8Layout<T, Dp>::kRing
                                      ? Layout<T, Dp>::kRing
                                      : Int8Layout<T, Dp>::kRing;
  static constexpr size_t kSmem = kRing + Layout<T, Dp>::kQSmem;
};

// The page-resident prefix of each twin: float pages of q's type, read
// through the chunk's ring, or int8 pages with their scale pages.
template <typename T>
struct FloatPrefix {
  const T* k;  // (N, KVH, bs, D)
  const T* v;
  static constexpr bool kInt8 = false;
  template <int Dp>
  using Smem = Layout<T, Dp>;
};

template <typename T>
struct Int8Prefix {
  const int8_t* k;  // (N, KVH, bs, D)
  const int8_t* v;
  const T* ks;      // (N, KVH, bs)
  const T* vs;
  static constexpr bool kInt8 = true;
  template <int Dp>
  using Smem = PrefillInt8Layout<T, Dp>;
};

// ``vec``: the float rows (the chunk's, and the float prefix pages) go by
// 16-byte cp.async; ``qvec``: the int8 twin's copy mode (int8_vec); ``qt``:
// query rows per q tile of the reference's Pallas kernel, which zeroes its
// tiles that start at or past valid[b].
template <typename T, int Dp, typename Prefix>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    prefill_mma_kernel(const T* __restrict__ q, Prefix prefix,
                       const T* __restrict__ chunk_k,
                       const T* __restrict__ chunk_v,
                       const int* __restrict__ block_table,
                       const int* __restrict__ starts,
                       const int* __restrict__ valid, T* __restrict__ out,
                       int H, int KVH, int C, int D, int N, int bs, int nb,
                       int TQ, int vec, int qvec, int qt) {
  using S = typename Prefix::template Smem<Dp>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.x * TQ;  // first chunk position of this q tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = G * TQ;  // row r: head kvh * G + r / TQ, position c0 + r % TQ
  const int vd = min(valid[b], C);
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  // rows at or past live_end are zeros; below it every row is computed
  const int live_end = vd <= 0 ? 0 : min(C, (vd + qt - 1) / qt * qt);

  if (c0 + TQ > live_end) {
    const T z = from_float<T>(0.f);
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D;
      const int c = c0 + r % TQ;
      if (c >= live_end && c < C)
        out[((head0 + r / TQ) * C + c) * D + e % D] = z;
    }
    if (c0 >= live_end) return;
  }

  // a row past live_end is not live: it loads no q and writes nothing
  const RowPair rp(head0, rows, TQ, c0, live_end);
  Mma<T, Dp> mma;
  mma.load_q(reinterpret_cast<uint32_t*>(smem_raw + S::kRing),
             rp.live[0] ? q + (rp.head[0] * C + rp.pos[0]) * D : nullptr,
             rp.live[1] ? q + (rp.head[1] * C + rp.pos[1]) * D : nullptr, D);
  Softmax<Dp> sm;

  // the prefix: chunk queries all sit at positions >= starts[b], so every
  // live prefix key is visible to every row; then the chunk's own keys,
  // causal and below valid[b] (keys past this tile's last query are
  // invisible to all of its rows)
  PrefillTiles<T> tiles;
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
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const bool compute = 16 * (int)(threadIdx.x >> 5) < rows;
  if constexpr (Prefix::kInt8) {
    PrefillInt8Tiles<T> pre;
    pre.kp = prefix.k;
    pre.vp = prefix.v;
    pre.ck = nullptr;
    pre.cv = nullptr;
    pre.bt_row = tiles.bt_row;
    pre.n = pre.tp = tiles.tp;
    pre.n_prefix = tiles.n_prefix;
    pre.n_chunk = 0;
    pre.c0 = c0;
    pre.N = N;
    pre.KVH = KVH;
    pre.kvh = kvh;
    pre.bs = bs;
    pre.row0 = 0;
    pre.ks = prefix.ks;
    pre.vs = prefix.vs;
    int8_key_loop<T, Dp, 1>(smem_raw, pre, mma, sm, rp, scale_log2, D,
                            (qvec & 1) != 0, qvec >> 1, compute);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the int8 ring
    tiles.kp = tiles.vp = nullptr;  // the chunk's loop reads no page
    tiles.n -= tiles.tp;
    tiles.tp = 0;
  } else {
    tiles.kp = prefix.k;
    tiles.vp = prefix.v;
  }
  key_loop<T, Dp>(reinterpret_cast<T*>(smem_raw), tiles, mma, sm, rp,
                  scale_log2, D, vec != 0, compute);

  T* const dst[2] = {rp.live[0] ? out + (rp.head[0] * C + rp.pos[0]) * D : nullptr,
                     rp.live[1] ? out + (rp.head[1] * C + rp.pos[1]) * D : nullptr};
  sm.write(dst, D);
}

// Launch either twin with the wrapper's plan (TQ positions per tile, Dp,
// smem bytes); heads or sizes the kernel does not take, a plan this file
// does not instantiate, or one whose bytes differ from the twin's shared
// layout are refused.
template <typename T, typename Prefix>
int launch_prefill(const void* q, const Prefix& prefix, const void* chunk_k,
                   const void* chunk_v, const int* block_table,
                   const int* starts, const int* valid, void* out, int B,
                   int H, int KVH, int C, int D, int N, int bs, int nb, int vec,
                   int qvec, int TQ, int qt, int Dp, int smem,
                   cudaStream_t stream) {
  if (B < 1 || KVH < 1 || H < 1 || H % KVH != 0 || C < 1 || N < 1 ||
      bs < 1 || nb < 1 || TQ < 1 || qt < 1 || (H / KVH) * TQ > kRows ||
      !valid_d_pad(D, Dp))
    return (int)cudaErrorInvalidValue;
  return with_d_pad(Dp, [&](auto dp) {
    constexpr int kDp = decltype(dp)::value;
    if ((size_t)smem != Prefix::template Smem<kDp>::kSmem)
      return (int)cudaErrorInvalidValue;
    const auto kernel = prefill_mma_kernel<T, kDp, Prefix>;
    const int err = allow_smem(kernel, (size_t)smem);
    if (err != 0) return err;
    const dim3 grid((C + TQ - 1) / TQ, KVH, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        (const T*)q, prefix, (const T*)chunk_k, (const T*)chunk_v,
        block_table, starts, valid, (T*)out, H, KVH, C, D, N, bs, nb, TQ, vec,
        qvec, qt);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int prefill_float(const void* q, const void* k_pages, const void* v_pages,
                  const void* chunk_k, const void* chunk_v, const int* bt,
                  const int* st, const int* vd, void* out, int B, int H,
                  int KVH, int C, int D, int N, int bs, int nb, int TQ,
                  int qt, int Dp, int smem, cudaStream_t s) {
  const void* rows[] = {k_pages, v_pages, chunk_k, chunk_v};
  return launch_prefill<T>(
      q, FloatPrefix<T>{(const T*)k_pages, (const T*)v_pages}, chunk_k,
      chunk_v, bt, st, vd, out, B, H, KVH, C, D, N, bs, nb,
      rows_aligned(D, sizeof(T), rows, 4), 0, TQ, qt, Dp, smem, s);
}

template <typename T>
int prefill_int8(const void* q, const void* k_pages, const void* v_pages,
                 const void* k_scale, const void* v_scale, const void* chunk_k,
                 const void* chunk_v, const int* bt, const int* st,
                 const int* vd, void* out, int B, int H, int KVH, int C, int D,
                 int N, int bs, int nb, int TQ, int qt, int Dp, int smem,
                 cudaStream_t s) {
  const Int8Prefix<T> prefix{(const int8_t*)k_pages, (const int8_t*)v_pages,
                             (const T*)k_scale, (const T*)v_scale};
  const void* rows[] = {chunk_k, chunk_v};
  return launch_prefill<T>(
      q, prefix, chunk_k, chunk_v, bt, st, vd, out, B, H, KVH, C, D, N, bs,
      nb, rows_aligned(D, sizeof(T), rows, 2),
      int8_vec(D, prefix.k, prefix.v, prefix.ks, prefix.vs, bs), TQ, qt, Dp,
      smem, s);
}

}  // namespace mma_attn

// dtype: 0 = float32, 1 = bfloat16; TQ, Dp, smem: the launch plan
// (kernels/common.py::attention_plan); qt: the reference's q tile
// (paged_prefill_attention.py::reference_q_tile).  Returns a cudaError_t
// (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* chunk_k, const void* chunk_v, const void* block_table,
    const void* starts, const void* valid, void* out, int B, int H, int KVH,
    int C, int D, int N, int bs, int nb, int dtype, int TQ, int qt, int Dp,
    int smem, void* stream) {
  using namespace mma_attn;
  const int* bt = (const int*)block_table;
  const int* st = (const int*)starts;
  const int* vd = (const int*)valid;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return prefill_float<float>(q, k_pages, v_pages, chunk_k, chunk_v, bt, st,
                                vd, out, B, H, KVH, C, D, N, bs, nb, TQ, qt,
                                Dp, smem, s);
  if (dtype == 1)
    return prefill_float<__nv_bfloat16>(q, k_pages, v_pages, chunk_k, chunk_v,
                                        bt, st, vd, out, B, H, KVH, C, D, N,
                                        bs, nb, TQ, qt, Dp, smem, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pages, float chunk k/v; dtype (of q, the scales, the chunk and out):
// 0 = float32, 1 = bfloat16; TQ, Dp, smem: the launch plan
// (kernels/common.py::attention_plan with quant); qt: as above.
extern "C" int paged_prefill_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* chunk_k,
    const void* chunk_v, const void* block_table, const void* starts,
    const void* valid, void* out, int B, int H, int KVH, int C, int D, int N,
    int bs, int nb, int dtype, int TQ, int qt, int Dp, int smem,
    void* stream) {
  using namespace mma_attn;
  const int* bt = (const int*)block_table;
  const int* st = (const int*)starts;
  const int* vd = (const int*)valid;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return prefill_int8<float>(q, k_pages, v_pages, k_scale, v_scale, chunk_k,
                               chunk_v, bt, st, vd, out, B, H, KVH, C, D, N,
                               bs, nb, TQ, qt, Dp, smem, s);
  if (dtype == 1)
    return prefill_int8<__nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                       chunk_k, chunk_v, bt, st, vd, out, B, H,
                                       KVH, C, D, N, bs, nb, TQ, qt, Dp,
                                       smem, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
