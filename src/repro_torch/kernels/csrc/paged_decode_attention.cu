// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends the first lengths[b] tokens of its KV pages.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention.
//
//   q            (B, H, D)          float32 or bfloat16
//   k/v_pages    (N, KVH, bs, D)    same type as q
//   block_table  (B, nb) int32      page id of each logical block; ids >= N
//                                   are sentinels (unallocated), clamped
//   lengths      (B,) int32         valid tokens INCLUDING the newest
//   out          (B, H, D)          q's type; 0 for a row with no valid key
//
// Bound on the H100: the bytes of live KV read, 2 * sum_b lengths[b] * KVH
// * D * sizeof(T), over 3.35 TB/s; the arithmetic (4 flops per key per
// query head and dimension) is far below the tensor-core line.  The design
// therefore reads each live page once per KV head: one CTA per
// (b, kv_head) holds the whole GQA group of H / KVH query rows, walks
// block_table[b, :ceil(lengths[b] / bs)] itself and stops at the last
// live key, so dead and sentinel pages cost no traffic.
#include "paged_attention.cuh"

namespace paged {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int KVH, int D, int N, int bs, int nb) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const Shared sh = carve(smem, G, D);
  const float scale = 1.f / sqrtf((float)D);
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads)
    sh.q[e] = to_float(qb[e]) * scale;
  float acc[kAcc];
  init_rows(sh, G, acc);

  const int n_keys = min(lengths[b], nb * bs);
  const int* bt_row = block_table + (size_t)b * nb;
  const auto all = [](int, int) { return true; };
  for (int k0 = 0; k0 < n_keys; k0 += kTileK) {
    const int nk = min(kTileK, n_keys - k0);
    load_page_tile(sh, k_pages, v_pages, bt_row, kvh, KVH, bs, D, N, k0, nk);
    fold_tile(sh, G, D, nk, all, acc);
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < G * D) ob[idx] = from_float<T>(acc[i] / fmaxf(sh.l[idx / D], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_table, const int* lengths, void* out, int B, int H,
           int KVH, int D, int N, int bs, int nb, cudaStream_t stream) {
  const size_t smem = shared_bytes(H / KVH, D);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_decode_kernel<T><<<dim3(KVH, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, block_table, lengths,
      (T*)out, H, KVH, D, N, bs, nb);
  return (int)cudaGetLastError();
}

}  // namespace paged

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* lengths, void* out, int B,
                                      int H, int KVH, int D, int N, int bs,
                                      int nb, int dtype, void* stream) {
  using namespace paged;
  if (B < 1 || KVH < 1 || H % KVH != 0 || H / KVH > kMaxRows || D < 1 ||
      D > kMaxD || N < 1 || bs < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int* bt = (const int*)block_table;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, bt, len, out, B, H, KVH, D, N,
                         bs, nb, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt, len, out, B, H, KVH,
                                 D, N, bs, nb, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
