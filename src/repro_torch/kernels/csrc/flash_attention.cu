// Flash (self-)attention for Hopper (sm_90a): causal or sliding-window
// attention of a whole sequence, the training path's attention.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel).
//
//   q      (B, H, Lq, D)     float32 or bfloat16
//   k/v    (B, KVH, Lkv, D)  q's type; query head h reads KV head h / (H/KVH)
//   out    (B, H, Lq, D)     q's type
//
// Query position i and key position j both count from 0 (top-left
// alignment, as the TPU kernel's q_pos / k_pos).  Key j is visible to
// query i iff j < Lkv, and j <= i when causal, and j > i - window when a
// window is set (window <= 0: none).  Scores are (q . k) / sqrt(D) with f32
// accumulation, folded into an f32 online softmax; the output is acc /
// max(l, 1e-20), so a row that sees no key writes 0 (on the training path,
// Lq == Lkv and every row sees its own key).
//
// Bound on the H100: at the training path's shapes the products, 4 flops
// per (query head, visible key, dimension) -- about half of the square
// when causal -- against q, k, v and out moved once; in f32 at the 3xTF32
// rate (495 / 3 TFLOP/s), the fastest f32-accurate rate the card has.
// The kernel runs the tensor-core core of mma_attention.cuh: one CTA per
// (b, KV head, q tile) holds the GQA group's rows for a tile of positions
// (group * tile <= 64 rows, 16 per warp), so each k/v tile is read from
// device memory once per KV head and q tile, not once per query head; 64-
// key tiles arrive by cp.async into a ring of shared stages while earlier
// tiles' products run as mma.sync (bf16, or 3xTF32 for f32) with the
// scores, the probabilities and the output in registers.  The CTA walks
// only the key tiles some of its rows can see -- it stops after its last
// query's position when causal and starts at its first query's position -
// window + 1 under a window, as the TPU kernel skips fully masked tiles --
// and evaluates a per-element mask only on tiles that cross the causal
// diagonal, the window's edge or the sequence's end.  The launch plan
// (positions per tile, padded D, shared bytes) comes from the Python
// wrapper (kernels/common.py::attention_plan) and is checked here.
#include "mma_attention.cuh"

namespace mma_attn {

// The key tiles of one CTA: keys [j_begin, j_end) of its (b, KV head).
template <typename T>
struct FlashTiles {
  const T* kg;
  const T* vg;
  int n, i0, i_last, j_begin, j_end, causal, window;
  size_t row0;

  __device__ __forceinline__ int nk(int t) const {
    return min(kTileN, j_end - j_begin - t * kTileN);
  }
  __device__ __forceinline__ size_t row(int t, int j) const {
    return row0 + j_begin + t * kTileN + j;
  }
  __device__ __forceinline__ const T* k(int) const { return kg; }
  __device__ __forceinline__ const T* v(int) const { return vg; }
  // per-element masks only on tiles that cross the causal diagonal, the
  // window's edge or the end of the keys
  __device__ __forceinline__ TileMask mask(int t) const {
    const int j0 = j_begin + t * kTileN;
    const int n_k = nk(t);
    const bool full = n_k == kTileN && (!causal || j0 + kTileN - 1 <= i0) &&
                      (window <= 0 || j0 > i_last - window);
    return TileMask{j0, n_k, causal, window, full};
  }
};

template <typename T, int Dp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int H,
                     int KVH, int Lq, int Lkv, int D, int TQ, int causal,
                     int window, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i0 = blockIdx.x * TQ;  // first query position of this tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = G * TQ;  // row r: head kvh * G + r / TQ, position i0 + r % TQ
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;

  const RowPair rp(head0, rows, TQ, i0, Lq);
  Mma<T, Dp> mma;
  mma.load_q(reinterpret_cast<uint32_t*>(smem_raw + Layout<T, Dp>::kRing),
             rp.live[0] ? q + (rp.head[0] * Lq + rp.pos[0]) * D : nullptr,
             rp.live[1] ? q + (rp.head[1] * Lq + rp.pos[1]) * D : nullptr, D);
  Softmax<Dp> sm;

  // keys some row of the tile can see: [j_begin, j_end)
  FlashTiles<T> tiles;
  tiles.kg = k;
  tiles.vg = v;
  tiles.i0 = i0;
  tiles.i_last = min(i0 + TQ, Lq) - 1;
  tiles.j_end = causal ? min(Lkv, tiles.i_last + 1) : Lkv;
  tiles.j_begin = window > 0 ? max(0, i0 - window + 1) : 0;
  tiles.n = tiles.j_end > tiles.j_begin
                ? (tiles.j_end - tiles.j_begin + kTileN - 1) / kTileN
                : 0;
  tiles.causal = causal;
  tiles.window = window;
  tiles.row0 = ((size_t)b * KVH + kvh) * Lkv;
  key_loop<T, Dp>(reinterpret_cast<T*>(smem_raw), tiles, mma, sm, rp,
                  kLog2e / sqrtf((float)D), D, vec,
                  16 * (int)(threadIdx.x >> 5) < rows);

  T* const dst[2] = {rp.live[0] ? out + (rp.head[0] * Lq + rp.pos[0]) * D : nullptr,
                     rp.live[1] ? out + (rp.head[1] * Lq + rp.pos[1]) * D : nullptr};
  sm.write(dst, D);
}

// Launch with the wrapper's plan (TQ positions per tile, Dp, smem bytes);
// a plan this file does not instantiate, or whose bytes differ from the
// ring's, is refused.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KVH, int Lq, int Lkv, int D, int causal, int window,
           int TQ, int Dp, int smem, cudaStream_t stream) {
  if (TQ < 1 || (H / KVH) * TQ > kRows || !valid_d_pad(D, Dp))
    return (int)cudaErrorInvalidValue;
  const void* rows[] = {k, v};
  const int vec = rows_aligned(D, sizeof(T), rows, 2);
  return with_d_pad(Dp, [&](auto dp) {
    constexpr int kDp = decltype(dp)::value;
    if ((size_t)smem != Layout<T, kDp>::kSmem) return (int)cudaErrorInvalidValue;
    const int err = allow_smem(flash_mma_kernel<T, kDp>, (size_t)smem);
    if (err != 0) return err;
    const dim3 grid((Lq + TQ - 1) / TQ, KVH, B);
    flash_mma_kernel<T, kDp><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KVH, Lq, Lkv, D,
        TQ, causal, window, vec);
    return (int)cudaGetLastError();
  });
}

}  // namespace mma_attn

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1; window <= 0: none;
// TQ, Dp, smem: the launch plan (kernels/common.py::attention_plan).
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KVH, int Lq,
                               int Lkv, int D, int causal, int window,
                               int dtype, int TQ, int Dp, int smem,
                               void* stream) {
  using namespace mma_attn;
  if (B < 1 || KVH < 1 || H % KVH != 0 || H / KVH > kRows || Lq < 1 ||
      Lkv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, KVH, Lq, Lkv, D, causal, window,
                         TQ, Dp, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, KVH, Lq, Lkv, D, causal,
                                 window, TQ, Dp, smem, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
