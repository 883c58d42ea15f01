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
// window is set (window <= 0: none).  Scores are (q / sqrt(D)) . k in f32,
// folded into an f32 online softmax; the output is acc / max(l, 1e-20), so
// a row that sees no key writes 0 (on the training path, Lq == Lkv and
// every row sees its own key).
//
// Bound on the H100: at the training path's shapes the arithmetic, 4
// flops per (query head, visible key, dimension) -- about half of the
// square when causal -- against q, k, v and out read or written once.  One
// CTA per (b, KV head, q tile) holds the GQA group's query rows for a tile
// of positions (group * tile <= 64 rows), so each k/v tile is read from
// device memory once per KV head and q tile, not once per query head.  The
// CTA walks only the key tiles some of its rows can see: it stops after
// its last query's position when causal and starts at its first query's
// position - window + 1 under a window, so the TPU kernel's skip of fully
// masked tiles carries over and causal work stays about half the square.
// The products run on the CUDA cores, not the tensor cores: this first
// version favours a simple, exact design (the shared pieces are those of
// the serving kernels, csrc/paged_attention.cuh).
#include "paged_attention.cuh"

namespace paged {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, FloatKV<T> kv, T* __restrict__ out,
                 int H, int KVH, int Lq, int Lkv, int D, int TQ, int causal,
                 int window) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * TQ;  // first query position of this tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = G * TQ;  // row r: head kvh * G + r / TQ, position i0 + r % TQ
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;

  const Shared sh = carve(smem, rows, D);
  const float scale = 1.f / sqrtf((float)D);
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D;
    const int i = i0 + r % TQ;
    sh.q[e] = i < Lq ? to_float(q[((head0 + r / TQ) * Lq + i) * D + e % D]) *
                           scale
                     : 0.f;
  }
  float acc[kAcc];
  init_rows(sh, rows, acc);

  // keys some row of the tile can see: [j_begin, j_end)
  const int i_last = min(i0 + TQ, Lq) - 1;
  const int j_end = causal ? min(Lkv, i_last + 1) : Lkv;
  const int j_begin = window > 0 ? max(0, i0 - window + 1) : 0;
  const size_t row0 = ((size_t)b * KVH + kvh) * Lkv;
  for (int j0 = j_begin; j0 < j_end; j0 += kTileK) {
    const int nk = min(kTileK, j_end - j0);
    load_row_tile(sh, kv, row0, D, j0, nk);
    const auto visible = [=](int r, int j) {
      const int i = i0 + r % TQ;
      const int key = j0 + j;
      return (!causal || key <= i) && (window <= 0 || key > i - window);
    };
    fold_tile(sh, rows, D, nk, visible, acc);
  }
  __syncthreads();

#pragma unroll
  for (int n = 0; n < kAcc; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    if (idx < rows * D) {
      const int r = idx / D;
      const int i = i0 + r % TQ;
      if (i < Lq)
        out[((head0 + r / TQ) * Lq + i) * D + idx % D] =
            from_float<T>(acc[n] / fmaxf(sh.l[r], 1e-20f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KVH, int Lq, int Lkv, int D, int causal, int window,
           cudaStream_t stream) {
  // query positions per tile: the GQA group times TQ fills <= kMaxRows rows
  const int fit = kMaxRows / (H / KVH);
  const int TQ = Lq < fit ? Lq : fit;
  const size_t smem = shared_bytes((H / KVH) * TQ, D);
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Lq + TQ - 1) / TQ, KVH, B);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, FloatKV<T>{(const T*)k, (const T*)v}, (T*)out, H, KVH, Lq,
      Lkv, D, TQ, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace paged

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1; window <= 0: none.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KVH, int Lq,
                               int Lkv, int D, int causal, int window,
                               int dtype, void* stream) {
  using namespace paged;
  if (!valid_heads(B, H, KVH, D) || Lq < 1 || Lkv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, KVH, Lq, Lkv, D, causal, window,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, KVH, Lq, Lkv, D, causal,
                                 window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
