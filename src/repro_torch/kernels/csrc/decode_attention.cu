// Dense decode attention for Hopper (sm_90a): one query token per sequence
// attends the first lengths[b] rows of its own slot of a dense per-slot
// KV cache.
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/decode_attention.py::decode_attention and
// ::decode_attention_quant (its int8 twin).
//
//   q        (B, H, D)        float32 or bfloat16
//   k/v      (B, KVH, S, D)   same type as q, or int8 (the quant twin)
//   k/v_scale (B, KVH, S)     quant twin only: one scale per row, in q's
//                             type; a row is f32(x) * f32(scale)
//   lengths  (B,) int32       valid rows INCLUDING the newest token; rows
//                             at or past min(lengths[b], S) are not read
//   out      (B, H, D)        q's type; 0 for a row with no valid key
//
// Bound on the H100: the bytes of live KV read, 2 * sum_b min(lengths[b],
// S) * KVH * D * sizeof(element) (plus the int8 twin's scales), over
// 3.35 TB/s; 4 flops per key, query head and dimension is far below the
// tensor-core line.  The CTAs of a (b, kv_head) hold the whole GQA group
// of query rows, so each live row is read once per KV head, and walk the
// contiguous (S, D) rows of the slot only up to the last live one: the
// tail is masked by the loop bound, not padded to a tile multiple (the
// Pallas wrapper pads S to 256).
//
// Both kernels are the split-KV tensor-core decode of decode_mma.cuh:
// (splits, KVH, B) CTAs, 64-key tiles by cp.async, the group's rows on
// mma.sync, and the last CTA of a (b, kv_head) to finish merging the
// partials when the plan has more than one split
// (kernels/common.py::decode_plan).  The int8 twin brings the int8 rows
// and their scales in by cp.async (the scales by 16-byte pieces when S is
// a multiple of 8 in bf16, else in smaller pieces or key by key), converts
// the rows exactly into bf16 (f32) tiles, and applies the k-scales to the
// scores and the v-scales to the probabilities in f32.
#include "decode_mma.cuh"

// dtype: 0 = float32, 1 = bfloat16; splits, Dp, smem: the launch plan
// (kernels/common.py::decode_plan); ws and tickets: its f32 workspace and
// B * KVH zeroed int32 arrival counters when splits > 1, else NULL.
// Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* ws,
                                void* tickets, int B, int H, int KVH, int S,
                                int D, int dtype, int splits, int Dp,
                                int smem, void* stream) {
  using namespace mma_attn;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_decode<float>(
        q, DenseSource<float>{(const float*)k, (const float*)v, S, KVH}, len,
        out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(
        q,
        DenseSource<__nv_bfloat16>{(const __nv_bfloat16*)k,
                                   (const __nv_bfloat16*)v, S, KVH},
        len, out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  return (int)cudaErrorInvalidValue;
}

// int8 k/v; dtype (of q, the scales and out): 0 = float32, 1 = bfloat16;
// the plan (kernels/common.py::decode_plan with quant) and the workspace
// as above.
extern "C" int decode_attention_quant(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale,
                                      const void* lengths, void* out,
                                      void* ws, void* tickets, int B, int H,
                                      int KVH, int S, int D, int dtype,
                                      int splits, int Dp, int smem,
                                      void* stream) {
  using namespace mma_attn;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const DenseSource<int8_t> rows{(const int8_t*)k, (const int8_t*)v, S, KVH};
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_decode<float>(
        q,
        DenseInt8Source<float>{rows, (const float*)k_scale,
                               (const float*)v_scale},
        len, out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(
        q,
        DenseInt8Source<__nv_bfloat16>{rows, (const __nv_bfloat16*)k_scale,
                                       (const __nv_bfloat16*)v_scale},
        len, out, ws, tickets, B, H, KVH, D, splits, Dp, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
