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
// Both kernels are the split-KV tensor-core decode of decode_mma.cuh:
// (splits, KVH, B) CTAs, 64-key tiles gathered from the pages by cp.async
// (each row's block-table read and page clamp a tile ahead), the group's
// rows on mma.sync, and the last CTA of a (b, kv_head) to finish merging
// the partials when the plan has more than one split
// (kernels/common.py::decode_plan).  The int8 twin brings the int8 rows
// (1 KB a 16-token page at D 64) and their scales (32 bytes a page in
// bf16) in by cp.async too, converts the rows exactly into bf16 (f32)
// tiles, and applies the k-scales to the scores and the v-scales to the
// probabilities in f32.
#include "decode_mma.cuh"

namespace {

bool valid_dims(int N, int bs, int nb) { return N >= 1 && bs >= 1 && nb >= 1; }

}  // namespace

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
  if (!valid_dims(N, bs, nb)) return (int)cudaErrorInvalidValue;
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

// int8 pages; dtype (of q, the scales and out): 0 = float32, 1 =
// bfloat16; the plan (kernels/common.py::decode_plan with quant) and the
// workspace as above.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* out, void* ws, void* tickets, int B, int H,
    int KVH, int D, int N, int bs, int nb, int dtype, int splits, int Dp,
    int smem, void* stream) {
  using namespace mma_attn;
  if (!valid_dims(N, bs, nb)) return (int)cudaErrorInvalidValue;
  const PagedSource<int8_t> rows{(const int8_t*)k_pages, (const int8_t*)v_pages,
                                 (const int*)block_table, nb, bs, N, KVH};
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_decode<float>(
        q,
        PagedInt8Source<float>{rows, (const float*)k_scale,
                               (const float*)v_scale},
        len, out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(
        q,
        PagedInt8Source<__nv_bfloat16>{rows, (const __nv_bfloat16*)k_scale,
                                       (const __nv_bfloat16*)v_scale},
        len, out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
