// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends the first lengths[b] tokens of its KV pages.
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention and
// ::paged_decode_attention_quant (its int8 twin).
//
//   q            (B, H, D)          float32 or bfloat16
//   k/v_pages    (N, KVH, bs, D)    same type as q, or int8 (the quant twin)
//   k/v_scale    (N, KVH, bs)       quant twin only: one scale per row, in
//                                   q's type; a row is f32(x) * f32(scale)
//   block_table  (B, nb) int32      page id of each logical block; ids >= N
//                                   are sentinels (unallocated), clamped
//   lengths      (B,) int32         valid tokens INCLUDING the newest
//   out          (B, H, D)          q's type; 0 for a row with no valid key
//
// Bound on the H100: the bytes of live KV read, 2 * sum_b lengths[b] * KVH
// * D * sizeof(element) (plus 2 * sum_b lengths[b] * KVH scales for the
// int8 twin), over 3.35 TB/s; the arithmetic (4 flops per key per query
// head and dimension) is far below the tensor-core line.  Each live page
// is read once per KV head: the CTAs of a (b, kv_head) hold the whole GQA
// group of H / KVH query rows, read block_table[b, :ceil(lengths[b] / bs)]
// themselves and stop at the last live key, so dead and sentinel pages
// cost no traffic.
//
// The float kernel is the split-KV tensor-core decode of decode_mma.cuh:
// (splits, KVH, B) CTAs, 64-key tiles gathered from the pages by 16-byte
// cp.async (each row's block-table read and page clamp a tile ahead), the
// group's rows on mma.sync, and a merge kernel when the plan has more than
// one split (kernels/common.py::decode_plan).  The int8 twin still runs
// the CUDA-core body of paged_attention.cuh (one CTA per (b, kv_head),
// 32-key tiles): it dequantizes each row as it lands in the f32 shared
// tile, so device memory is read as int8 payload plus scales.
#include "decode_mma.cuh"
#include "paged_attention.cuh"

namespace paged {

// The int8 twin's body (CUDA cores, 32-key tiles; KV = Int8KV<T>).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, KV kv,
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
    load_page_tile(sh, kv, bt_row, kvh, KVH, bs, D, N, k0, nk);
    fold_tile(sh, G, D, nk, all, acc);
  }
  __syncthreads();
  write_rows(out + ((size_t)b * H + (size_t)kvh * G) * D, sh, G, D, acc);
}

template <typename T, typename KV>
int launch(const void* q, KV kv, const int* block_table, const int* lengths,
           void* out, int B, int H, int KVH, int D, int N, int bs, int nb,
           cudaStream_t stream) {
  const size_t smem = shared_bytes(H / KVH, D);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_decode_kernel<T, KV><<<dim3(KVH, B), kThreads, smem, stream>>>(
      (const T*)q, kv, block_table, lengths, (T*)out, H, KVH, D, N, bs, nb);
  return (int)cudaGetLastError();
}

inline bool valid_dims(int B, int H, int KVH, int D, int N, int bs, int nb) {
  return valid_heads(B, H, KVH, D) && N >= 1 && bs >= 1 && nb >= 1;
}

}  // namespace paged

// dtype: 0 = float32, 1 = bfloat16; splits, Dp, smem: the launch plan
// (kernels/common.py::decode_plan); ws and tickets: its f32 workspace and
// B * KVH zeroed int32 arrival counters when splits > 1, else NULL.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* lengths, void* out,
                                      void* ws, void* tickets, int B, int H,
                                      int KVH, int D, int N, int bs, int nb,
                                      int dtype, int splits, int Dp,
                                      int smem, void* stream) {
  using namespace mma_attn;
  if (!paged::valid_dims(B, H, KVH, D, N, bs, nb))
    return (int)cudaErrorInvalidValue;
  const int* bt = (const int*)block_table;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_decode<float>(
        q,
        PagedSource<float>{(const float*)k_pages, (const float*)v_pages, bt,
                           nb, bs, N, KVH},
        len, out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(
        q,
        PagedSource<__nv_bfloat16>{(const __nv_bfloat16*)k_pages,
                                   (const __nv_bfloat16*)v_pages, bt, nb, bs,
                                   N, KVH},
        len, out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  return (int)cudaErrorInvalidValue;
}

// int8 pages; dtype (of q, the scales and out): 0 = float32, 1 = bfloat16.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* out, int B, int H, int KVH, int D, int N,
    int bs, int nb, int dtype, void* stream) {
  using namespace paged;
  if (!valid_dims(B, H, KVH, D, N, bs, nb)) return (int)cudaErrorInvalidValue;
  const int* bt = (const int*)block_table;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* kq = (const int8_t*)k_pages;
  const int8_t* vq = (const int8_t*)v_pages;
  if (dtype == 0)
    return launch<float>(
        q,
        Int8KV<float>{kq, vq, (const float*)k_scale, (const float*)v_scale},
        bt, len, out, B, H, KVH, D, N, bs, nb, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        q,
        Int8KV<__nv_bfloat16>{kq, vq, (const __nv_bfloat16*)k_scale,
                              (const __nv_bfloat16*)v_scale},
        bt, len, out, B, H, KVH, D, N, bs, nb, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
