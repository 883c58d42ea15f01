// Split-KV decode attention on the tensor-core core of mma_attention.cuh
// (sm_90a): one query token per sequence and query head attends the first
// lengths[b] keys of its sequence, read from the KV page pool (paged
// decode) or from the sequence's own slot of a dense cache (dense decode).
// The float entries of paged_decode_attention.cu and decode_attention.cu
// launch it; their int8 twins keep paged_attention.cuh's CUDA-core body.
//
// Decode does 4 flops per key, query head and dimension, far below the
// H100's ridge of about 295 flops a byte, so the bound is the bytes of
// live KV, read once per KV head at 3.35 TB/s, and the only way to it is
// to keep enough 16-byte loads in flight on every SM.  The design:
//
//   * Split-KV.  The grid is (splits, KVH, B).  The split count comes from
//     the host's plan (kernels/common.py::decode_plan), which reads shapes
//     only (the cap nb * bs or S, B * KVH, the 132 SMs: at most three CTAs
//     an SM, all in the first wave), never lengths, so the launch needs no
//     device-to-host read and replays in a CUDA graph with any lengths.
//     Fewer, longer splits beat more: each split pays a pipeline fill and
//     a share of the merge.  On the device each sequence takes
//     n = min(lengths[b], cap) keys and uses ceil(n / kSplitMinKeys)
//     splits, at most ``splits``; the splits share n evenly in whole
//     64-key tiles (split_range, mirrored by common.py::split_range), so a
//     short sequence uses one split.  Every split below the sequence's
//     ``used`` count holds at least one key; a CTA past them stops at once
//     and writes nothing, since the merge reads only the used splits.
//   * The merge.  When a sequence uses one split, its CTA normalises and
//     writes the output itself.  Otherwise each CTA writes its f32 partial
//     (O unnormalised, row max m in raw score units, sum l) to a workspace
//     the wrapper allocates with torch.empty, and the last of the
//     sequence's splits to arrive merges them (merge_splits): each CTA
//     makes its partial visible (__threadfence) before it counts its
//     arrival on a per-(sequence, KV head) ticket, and the CTA that counts
//     the last arrival resets the ticket to 0, so the tickets are 0 again
//     for the next call and every graph replay.  The tickets are an int32
//     buffer the wrapper keeps per device, zeroed once
//     (kernels/common.py::split_tickets).  A last-arriving merge and not
//     a second kernel: a second kernel waits behind the decode grid's
//     last CTA, pays a launch, and then needs dependent trips to L2 of its
//     own, which at long context cost more than a tenth of the call even
//     when launched early as a programmatic dependent grid; the merger
//     here starts as soon as the last partial lands.  The merge runs in
//     split order with no float atomics, so the result is the same from
//     run to run.
//   * Loads.  Keys and values come in 64-key tiles by 16-byte cp.async
//     into mma_attention.cuh's ring (three stages in bf16, two in f32),
//     through its key_loop, eight threads to a key row so that each warp
//     instruction reads four whole 128-byte rows; each loader thread
//     computes its four rows' addresses for the next tile (the block-table
//     reads and the page clamp for pages; a shift, not a division, for
//     power-of-two pages) a tile ahead.  Sentinel page ids (>= N, or < 0)
//     are clamped into the pool before any address is formed.  The launch
//     bounds keep registers from costing the occupancy the plan counts on.
//   * Products.  The GQA group's G rows go on the tensor cores, padded to
//     the 16 rows of an mma.sync tile: bf16 m16n8k16, and 3xTF32 m16n8k8
//     for f32 (f32 accuracy).  At G <= 16 the four warps share the one
//     row tile and take interleaved 16-key slices of every 64-key tile,
//     each with its own (m, l, O); at G > 16 each warp owns a row tile, as
//     in prefill.  At the end the warps stage (m, l, O) in the ring's
//     shared memory and the CTA folds them into its output or partial.
#pragma once

#include "mma_attention.cuh"

namespace mma_attn {

constexpr int kSplitMinKeys = 256;  // no split takes fewer (common.py SPLIT_MIN_KEYS)
constexpr int kSplitMax = 64;       // common.py SPLIT_MAX
constexpr int kDecodeRowThreads = 8;  // loader threads a key row: whole 128-byte rows

// The keys a sequence of ``length`` keys gives each split.
struct SplitRange {
  int n;      // live keys, length clamped to [0, cap]
  int share;  // keys per split, whole tiles
  int used;   // splits that hold keys (1 when n == 0)
};

__device__ __forceinline__ SplitRange split_range(int length, int cap, int splits) {
  const int n = min(max(length, 0), cap);
  const int used = max(1, min(splits, (n + kSplitMinKeys - 1) / kSplitMinKeys));
  const int per = (n + used - 1) / used;
  const int share = max(kTileN, (per + kTileN - 1) / kTileN * kTileN);
  return {n, share, n == 0 ? 1 : (n + share - 1) / share};
}

// Keys [lo, hi) of one sequence and KV head in the page pool: position p
// lives in page bt_row[p / bs], row p % bs.
template <typename T>
struct PagedDecodeTiles {
  const T* kp;
  const T* vp;
  const int* bt_row;
  int n, lo, hi, N, KVH, kvh, bs, shift;  // shift: log2(bs), or -1

  __device__ __forceinline__ int nk(int t) const { return min(kTileN, hi - lo - t * kTileN); }
  __device__ __forceinline__ size_t row(int t, int j) const {
    const int pos = lo + t * kTileN + j;
    const int blk = shift >= 0 ? pos >> shift : pos / bs;
    int page = bt_row[blk];
    page = page < 0 ? 0 : (page >= N ? N - 1 : page);
    return ((size_t)page * KVH + kvh) * bs + (pos - blk * bs);
  }
  __device__ __forceinline__ const T* k(int) const { return kp; }
  __device__ __forceinline__ const T* v(int) const { return vp; }
  __device__ __forceinline__ TileMask mask(int t) const {
    const int n_k = nk(t);
    return TileMask{0, n_k, 0, 0, n_k == kTileN};
  }
};

template <typename T>
struct PagedSource {
  const T* k;  // (N, KVH, bs, D) pages
  const T* v;
  const int* bt;  // (B, nb)
  int nb, bs, N, KVH;

  __host__ __device__ __forceinline__ int cap() const { return nb * bs; }
  __device__ __forceinline__ PagedDecodeTiles<T> tiles(int b, int kvh, int lo,
                                                       int hi) const {
    const int shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
    return {k, v, bt + (size_t)b * nb, (hi - lo + kTileN - 1) / kTileN,
            lo, hi, N, KVH, kvh, bs, shift};
  }
};

// Keys [lo, hi) of one sequence and KV head in a dense (B, KVH, S, D) cache.
template <typename T>
struct DenseDecodeTiles {
  const T* kd;
  const T* vd;
  size_t row0;  // row 0 of (b, kvh)
  int n, lo, hi;

  __device__ __forceinline__ int nk(int t) const { return min(kTileN, hi - lo - t * kTileN); }
  __device__ __forceinline__ size_t row(int t, int j) const {
    return row0 + lo + t * kTileN + j;
  }
  __device__ __forceinline__ const T* k(int) const { return kd; }
  __device__ __forceinline__ const T* v(int) const { return vd; }
  __device__ __forceinline__ TileMask mask(int t) const {
    const int n_k = nk(t);
    return TileMask{0, n_k, 0, 0, n_k == kTileN};
  }
};

template <typename T>
struct DenseSource {
  const T* k;  // (B, KVH, S, D)
  const T* v;
  int S, KVH;

  __host__ __device__ __forceinline__ int cap() const { return S; }
  __device__ __forceinline__ DenseDecodeTiles<T> tiles(int b, int kvh, int lo,
                                                       int hi) const {
    return {k, v, ((size_t)b * KVH + kvh) * S, (hi - lo + kTileN - 1) / kTileN,
            lo, hi};
  }
};

// The workspace of B * KVH * splits * G partial rows: O (D floats a row),
// then m, then l (one float a row each).  Partial row of (b, kvh, split
// x, query row r): ((b * KVH + kvh) * splits + x) * G + r.
struct Partials {
  float* o;
  float* m;
  float* l;
  __host__ __device__ Partials(float* ws, size_t rows, int D)
      : o(ws), m(ws + rows * D), l(ws + rows * D + rows) {}
};

// out = sum_x w_x O_x / sum_x w_x l_x over the ``used`` splits of one
// (sequence, KV head), in split order, with w_x = 2^((m_x - max m) log2(e)
// / sqrt(D)); every used split holds keys, so every m_x is finite and no
// -inf - -inf is formed.  Each thread folds two elements (r, d) online,
// eight splits at a time, with all their loads issued before the first is
// used: one trip to L2 (__ldcg: other CTAs wrote them) for up to eight
// splits.  A slot past ``used`` reads nothing and folds with weight 0; an
// element past G * D is folded but not written.
template <typename T>
__device__ __forceinline__ void merge_splits(const Partials& part, size_t part0,
                                             size_t head0, T* __restrict__ out,
                                             int G, int D, int used,
                                             float scale_log2) {
  constexpr int kE = 2, kX = 8;
  for (int e0 = threadIdx.x; e0 < G * D; e0 += kE * kThreads) {
    float mx[kE], o[kE], l[kE];
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      mx[k] = kNegInf;
      o[k] = 0.f;
      l[k] = 0.f;
    }
    for (int x0 = 0; x0 < used; x0 += kX) {  // x0 < used: slot 0 is live
      float mv[kE][kX], lv[kE][kX], ov[kE][kX];
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int e = e0 + k * kThreads;
        const int r = e / D;
        const int d = e - r * D;
#pragma unroll
        for (int i = 0; i < kX; ++i) {
          const bool live = e < G * D && x0 + i < used;
          const size_t row = part0 + (size_t)(x0 + i) * G + r;
          mv[k][i] = live ? __ldcg(part.m + row) : kNegInf;
          lv[k][i] = live ? __ldcg(part.l + row) : 0.f;
          ov[k][i] = live ? __ldcg(part.o + row * D + d) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kE; ++k)
#pragma unroll
        for (int i = 0; i < kX; ++i) {
          const float m_new = fmaxf(mx[k], mv[k][i]);
          const float a = exp2_approx((mx[k] - m_new) * scale_log2);  // 0 at the first split
          const float w = exp2_approx((mv[k][i] - m_new) * scale_log2);
          o[k] = o[k] * a + w * ov[k][i];
          l[k] = l[k] * a + w * lv[k][i];
          mx[k] = m_new;
        }
    }
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = e0 + k * kThreads;
      if (e < G * D) out[head0 * D + e] = from_float<T>(o[k] / fmaxf(l[k], 1e-20f));
    }
  }
}

// CTAs an SM holds by shared memory (1 KB of it reserved per CTA), at most
// the three the plan fills (common.py SPLIT_CTAS_PER_SM); the launch bounds
// keep registers from lowering that (170 a thread at three CTAs).
template <typename T, int Dp>
constexpr int decode_blocks_per_sm() {
  return (int)(232448 / (Layout<T, Dp>::kSmem + 1024)) < 3
             ? (int)(232448 / (Layout<T, Dp>::kSmem + 1024))
             : 3;
}

template <typename T, int Dp, int KS, typename Src>
__global__ void __launch_bounds__(kThreads, (decode_blocks_per_sm<T, Dp>()))
    decode_mma_kernel(const T* __restrict__ q, Src src,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ tickets, int B,
                      int H, int KVH, int D, int splits, int vec) {
  using L = Layout<T, Dp>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int x = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const SplitRange sr = split_range(lengths[b], src.cap(), splits);
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  const size_t part0 = (((size_t)b * KVH + kvh) * splits + x) * G;
  if (x >= sr.used) return;  // no keys; the merge reads only used splits
  const Partials part(ws, (size_t)B * KVH * splits * G, D);
  const int lo = min(x * sr.share, sr.n);
  const int hi = min(lo + sr.share, sr.n);

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int rt = warp / KS;  // this warp's row tile: rows 16 rt .. 16 rt + 15
  const int r0 = 16 * rt + g;
  const bool compute = 16 * rt < G;
  Mma<T, Dp> mma;
  mma.load_q(reinterpret_cast<uint32_t*>(smem_raw + L::kRing),
             r0 < G ? q + (head0 + r0) * D : nullptr,
             r0 + 8 < G ? q + (head0 + r0 + 8) * D : nullptr, D);
  Softmax<Dp> sm;
  const RowPair rp(0, 0, 1, 0, 0);  // decode masks by key count only
  const float scale_log2 = kLog2e / sqrtf((float)D);
  key_loop<T, Dp, KS, kDecodeRowThreads>(reinterpret_cast<T*>(smem_raw),
                                         src.tiles(b, kvh, lo, hi), mma, sm, rp,
                                         scale_log2, D, vec != 0, compute);

  // stage each warp's (m, l, O) in the ring, then fold the warps that share
  // a row tile into the output (one split) or this split's partial
  constexpr int kOS = Dp + 8;  // floats per staged row: float2 stores hit distinct banks
  static_assert(sizeof(float) * kWarps * 16 * (kOS + 2) <= L::kRing,
                "the staged warp outputs must fit in the ring");
  float* os = reinterpret_cast<float*>(smem_raw);  // [warp][16][kOS]
  float* ms = os + kWarps * 16 * kOS;              // [warp][16]
  float* ls = ms + kWarps * 16;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  if (compute) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tot = sm.l[h];
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
      const int rr = 16 * warp + g + 8 * h;
      if (t4 == 0) {
        ms[rr] = sm.m[h];
        ls[rr] = tot;
      }
#pragma unroll
      for (int d = 0; d < Dp / 8; ++d)
        *reinterpret_cast<float2*>(os + rr * kOS + 8 * d + 2 * t4) =
            make_float2(sm.o[d][2 * h], sm.o[d][2 * h + 1]);
    }
  }
  __syncthreads();
  const bool direct = ws == nullptr || sr.used == 1;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int w0 = (r / 16) * KS;  // the first warp of row r's tile
    const int rr = r % 16;
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < KS; ++s) mx = fmaxf(mx, ms[(w0 + s) * 16 + rr]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int sr_row = (w0 + s) * 16 + rr;
      const float m = ms[sr_row];
      const float w = m == kNegInf ? 0.f : exp2_approx((m - mx) * scale_log2);
      o += w * os[sr_row * kOS + d];
      l += w * ls[sr_row];
    }
    if (direct) {
      out[(head0 + r) * D + d] = from_float<T>(o / fmaxf(l, 1e-20f));
    } else {
      part.o[(part0 + r) * D + d] = o;
      if (d == 0) {
        part.m[part0 + r] = mx;
        part.l[part0 + r] = l;
      }
    }
  }
  if (direct) return;

  // The last of the sequence's used splits to arrive merges them all: each
  // CTA's partial is made visible before its arrival is counted, and the
  // merger, having counted the last arrival, reads the partials from L2.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const size_t bk = (size_t)b * KVH + kvh;
  if (threadIdx.x == 0) last = atomicAdd(tickets + bk, 1) == sr.used - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[bk] = 0;  // ready for the next call or replay
  merge_splits(part, bk * splits * G, head0, out, G, D, sr.used, scale_log2);
}

template <typename T, int Dp, int KS, typename Src>
int run_decode(const T* q, const Src& src, const int* lengths, T* out,
               float* ws, int* tickets, int B, int H, int KVH, int D,
               int splits, int smem, int vec, cudaStream_t stream) {
  const int err = allow_smem(decode_mma_kernel<T, Dp, KS, Src>, (size_t)smem);
  if (err != 0) return err;
  decode_mma_kernel<T, Dp, KS, Src><<<dim3(splits, KVH, B), kThreads, smem, stream>>>(
      q, src, lengths, out, ws, tickets, B, H, KVH, D, splits, vec);
  return (int)cudaGetLastError();
}

// Launch the decode kernel with the wrapper's plan (splits, Dp, smem
// bytes).  A plan this file does not instantiate, whose bytes differ from
// the ring's, or whose workspace and tickets are missing (splits > 1) or
// extra (splits == 1) is refused.
template <typename T, typename Src>
int launch_decode(const void* q, const Src& src, const int* lengths, void* out,
                  void* ws, void* tickets, int B, int H, int KVH, int D,
                  int splits, int Dp, int smem, cudaStream_t stream) {
  const int G = H / KVH;
  if (G > kRows || splits < 1 || splits > kSplitMax ||
      (splits > 1) != (ws != nullptr) || (splits > 1) != (tickets != nullptr) ||
      !valid_d_pad(D, Dp))
    return (int)cudaErrorInvalidValue;
  const void* rows[] = {src.k, src.v};
  const int vec = rows_aligned(D, sizeof(T), rows, 2);
  return with_d_pad(Dp, [&](auto dp) {
    constexpr int kDp = decltype(dp)::value;
    if ((size_t)smem != Layout<T, kDp>::kSmem) return (int)cudaErrorInvalidValue;
    return G <= 16 ? run_decode<T, kDp, 4>((const T*)q, src, lengths, (T*)out,
                                           (float*)ws, (int*)tickets, B, H, KVH,
                                           D, splits, smem, vec, stream)
                   : run_decode<T, kDp, 1>((const T*)q, src, lengths, (T*)out,
                                           (float*)ws, (int*)tickets, B, H, KVH,
                                           D, splits, smem, vec, stream);
  });
}

}  // namespace mma_attn
