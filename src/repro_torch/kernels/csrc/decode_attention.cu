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
// tensor-core line.  One CTA per (b, kv_head) holds the whole GQA group of
// query rows, so each live row is read once per KV head, and walks the
// contiguous (S, D) rows of its slot only up to the last live one: the
// tail is masked by the loop bound, not padded to a tile multiple (the
// Pallas wrapper pads S to 256).  The int8 twin dequantizes each row as
// it lands in the f32 shared tile.
#include "paged_attention.cuh"

namespace paged {

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, KV kv,
                  const int* __restrict__ lengths, T* __restrict__ out, int H,
                  int KVH, int S, int D) {
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

  const int n_keys = min(lengths[b], S);
  const size_t row0 = ((size_t)b * KVH + kvh) * S;
  const auto all = [](int, int) { return true; };
  for (int k0 = 0; k0 < n_keys; k0 += kTileK) {
    const int nk = min(kTileK, n_keys - k0);
    load_row_tile(sh, kv, row0, D, k0, nk);
    fold_tile(sh, G, D, nk, all, acc);
  }
  __syncthreads();
  write_rows(out + ((size_t)b * H + (size_t)kvh * G) * D, sh, G, D, acc);
}

template <typename T, typename KV>
int launch(const void* q, KV kv, const int* lengths, void* out, int B, int H,
           int KVH, int S, int D, cudaStream_t stream) {
  const size_t smem = shared_bytes(H / KVH, D);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_kernel<T, KV><<<dim3(KVH, B), kThreads, smem, stream>>>(
      (const T*)q, kv, lengths, (T*)out, H, KVH, S, D);
  return (int)cudaGetLastError();
}

}  // namespace paged

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int H,
                                int KVH, int S, int D, int dtype,
                                void* stream) {
  using namespace paged;
  if (!valid_heads(B, H, KVH, D) || S < 1) return (int)cudaErrorInvalidValue;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, FloatKV<float>{(const float*)k, (const float*)v},
                         len, out, B, H, KVH, S, D, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        q,
        FloatKV<__nv_bfloat16>{(const __nv_bfloat16*)k,
                               (const __nv_bfloat16*)v},
        len, out, B, H, KVH, S, D, st);
  return (int)cudaErrorInvalidValue;
}

// int8 k/v; dtype (of q, the scales and out): 0 = float32, 1 = bfloat16.
extern "C" int decode_attention_quant(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale,
                                      const void* lengths, void* out, int B,
                                      int H, int KVH, int S, int D, int dtype,
                                      void* stream) {
  using namespace paged;
  if (!valid_heads(B, H, KVH, D) || S < 1) return (int)cudaErrorInvalidValue;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* kq = (const int8_t*)k;
  const int8_t* vq = (const int8_t*)v;
  if (dtype == 0)
    return launch<float>(
        q,
        Int8KV<float>{kq, vq, (const float*)k_scale, (const float*)v_scale},
        len, out, B, H, KVH, S, D, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        q,
        Int8KV<__nv_bfloat16>{kq, vq, (const __nv_bfloat16*)k_scale,
                              (const __nv_bfloat16*)v_scale},
        len, out, B, H, KVH, S, D, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
