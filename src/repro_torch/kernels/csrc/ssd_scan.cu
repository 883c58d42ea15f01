// Mamba2 SSD chunked scan for Hopper (sm_90a): the scan of the mamba2
// prefill path (ssm_lm.prefill -> mamba_block_full -> ssd_chunked).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (body _ssd_kernel), and adds what the serving path needs beyond it: an
// initial state in and the final state out.
//
//   x      (B, L, H, P)   float32 or bfloat16
//   dt     (B, L, H)      float32
//   A      (H,)           float32, negative
//   Bm/Cm  (B, L, G, N)   x's type; head h reads group h / (H / G)
//   init   (B, H, N, P)   float32, or null for a zero state
//   y      (B, L, H, P)   x's type
//   final  (B, H, N, P)   float32, or null (not written)
//
// L is a multiple of the chunk length Q.  Per chunk, with cum the
// inclusive cumsum of dt * A over the chunk and h the state carried in:
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i h
//   h'  = exp(cum_Q) h + sum_j B_j (dt_j exp(cum_Q - cum_j)) x_j
//
// All arithmetic is f32.  exp(cum_i - cum_j) is evaluated only for
// j <= i: for j > i it is exp of a positive number that can overflow, and
// inf times a zero mask is NaN.
//
// Design.  The TPU kernel carries h in VMEM scratch across a sequential
// grid axis over chunks; here one CTA per (head, sequence) walks the
// chunks in a loop and keeps h (N x P f32) in shared memory, so the
// recurrence never leaves the SM.  Per chunk it stages x, dt, B and C as
// f32 in shared memory, takes the cumsum, then three small products on
// the CUDA cores: the masked Q x Q form C.B^T, y from it and from h, and
// the state update.  Each thread owns a tile of up to kMaxRows rows by 4
// adjacent columns of a product's output and reads the columns' operand
// as one float4 per reduction step, so an operand read from shared memory
// feeds 4 to 4 * kMaxRows multiply-adds.  Row strides of the operands read
// down a column (C, the form, B transposed) are padded so the lanes of a
// warp, on neighbouring rows, fall in distinct banks.
//
// Bound on the H100: bytes.  x, y, B, C, dt and the two f32 states move
// once; the products are about 4 N P + Q P flops per (position, head),
// 30 to 130 flops per byte moved at mamba2-130m's widths in bf16 (more as
// the sequence grows past the states' bytes), below the ~295 at which the
// bf16 tensor cores would bound it.  This first version
// is latency-bound instead (B x H CTAs, one chunk after another); tensor
// cores, TMA and a split over P for more CTAs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;  // rows of a product's output tile per thread
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a CTA's shared memory on sm_90

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Dims {
  int B, L, H, G, N, P, Q;
};

// Offsets (in floats) of the shared-memory arrays.  The float4-read
// arrays (x, h, B^T) come first, each a multiple of 4 floats long.
struct Layout {
  int x;    // Q x P: x of the chunk, then x_j * dt_j exp(cum_Q - cum_j)
  int h;    // N x P: the carried state
  int bt;   // N x (Q + 4): B of the chunk, transposed
  int c;    // Q x (N + 1): C of the chunk
  int att;  // Q x (Q + 1): (C_i . B_j) exp(cum_i - cum_j) dt_j, 0 for j > i
  int cum;  // Q: inclusive cumsum of dt * A
  int dt;   // Q
  int total;
};

__host__ __device__ inline Layout layout(int Q, int N, int P) {
  Layout s;
  s.x = 0;
  s.h = s.x + Q * P;
  s.bt = s.h + N * P;
  s.c = s.bt + N * (Q + 4);
  s.att = s.c + Q * (N + 1);
  s.cum = s.att + Q * (Q + 1);
  s.dt = s.cum + Q;
  s.total = s.dt + Q;
  return s;
}

// Whether a rows x cols product output splits into the thread tiles below.
inline bool fits(int rows, int cols) {
  if (cols % 4 != 0 || cols / 4 > kThreads) return false;
  const int rstep = kThreads / (cols / 4);
  return (rows + rstep - 1) / rstep <= kMaxRows;
}

// The tile of a rows x cols output owned by this thread: columns col ..
// col + 3 of rows row0, row0 + rstep, ... (nr of them).  Threads past the
// last whole group of cols / 4 own nothing.
struct Tile {
  int col, row0, rstep, nr;
};

__device__ __forceinline__ Tile tile(int rows, int cols) {
  const int groups = cols / 4;
  Tile t;
  t.rstep = kThreads / groups;
  t.col = 4 * (threadIdx.x % groups);
  t.row0 = threadIdx.x / groups;
  t.nr = (t.row0 < t.rstep && t.row0 < rows)
             ? (rows - t.row0 + t.rstep - 1) / t.rstep
             : 0;
  return t;
}

__device__ __forceinline__ int row_of(const Tile& t, int r) {
  return t.row0 + r * t.rstep;
}

// acc[r][q] += sum_{k < kend} a[row_r * ars + k * aks] * b[k * ldb + col + q]
// for the tile's rows row_r: one float4 of b per k feeds 4 * nr products.
// R rows are unrolled; kGuard skips rows past nr (nr < R), so a tile whose
// nr is exactly R issues no predicated-off work.
template <int R, bool kGuard>
__device__ __forceinline__ void mac_rows(float (&acc)[kMaxRows][4],
                                         const Tile& t, const float* a,
                                         int ars, int aks, const float* b,
                                         int ldb, int kend) {
  for (int k = 0; k < kend; ++k) {
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + t.col);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!kGuard || r < t.nr) {
        const float av = a[row_of(t, r) * ars + k * aks];
        acc[r][0] = fmaf(av, bv.x, acc[r][0]);
        acc[r][1] = fmaf(av, bv.y, acc[r][1]);
        acc[r][2] = fmaf(av, bv.z, acc[r][2]);
        acc[r][3] = fmaf(av, bv.w, acc[r][3]);
      }
    }
  }
}

__device__ __forceinline__ void mac_tile(float (&acc)[kMaxRows][4],
                                         const Tile& t, const float* a,
                                         int ars, int aks, const float* b,
                                         int ldb, int kend) {
  switch (t.nr) {
    case 0: return;
    case 1: return mac_rows<1, false>(acc, t, a, ars, aks, b, ldb, kend);
    case 2: return mac_rows<2, false>(acc, t, a, ars, aks, b, ldb, kend);
    case 4: return mac_rows<4, false>(acc, t, a, ars, aks, b, ldb, kend);
    case 8: return mac_rows<8, false>(acc, t, a, ars, aks, b, ldb, kend);
    case 16: return mac_rows<16, false>(acc, t, a, ars, aks, b, ldb, kend);
    default:
      if (t.nr < 4) return mac_rows<4, true>(acc, t, a, ars, aks, b, ldb, kend);
      if (t.nr < 8) return mac_rows<8, true>(acc, t, a, ars, aks, b, ldb, kend);
      return mac_rows<16, true>(acc, t, a, ars, aks, b, ldb, kend);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kMaxRows][4]) {
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init,
               T* __restrict__ y, float* __restrict__ fin, Dims d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q = d.Q, N = d.N, P = d.P;
  const Layout lay = layout(Q, N, P);
  float* sx = smem + lay.x;
  float* sh = smem + lay.h;
  float* sbt = smem + lay.bt;
  float* sc = smem + lay.c;
  float* satt = smem + lay.att;
  float* scum = smem + lay.cum;
  float* sdt = smem + lay.dt;
  const int QT = Q + 4, NS = N + 1, QS = Q + 1;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (d.H / d.G);
  const float a = A[h];
  const size_t state0 = ((size_t)b * d.H + h) * N * P;

#pragma unroll 4
  for (int e = threadIdx.x; e < N * P; e += kThreads)
    sh[e] = init != nullptr ? init[state0 + e] : 0.f;

  const Tile t_att = tile(Q, Q);  // rows i, columns j
  const Tile t_y = tile(Q, P);    // rows i, columns p
  const Tile t_h = tile(N, P);    // rows n, columns p
  float acc[kMaxRows][4];

  for (int l0 = 0; l0 < d.L; l0 += Q) {
    const size_t row0 = (size_t)b * d.L + l0;  // (b, l0) in (B, L)
    // unrolled so that several global loads are in flight per thread
#pragma unroll 4
    for (int e = threadIdx.x; e < Q * P; e += kThreads) {
      const int i = e / P;
      sx[e] = to_float(x[((row0 + i) * d.H + h) * P + e % P]);
    }
#pragma unroll 4
    for (int e = threadIdx.x; e < Q * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const size_t src = ((row0 + j) * d.G + g) * N + n;
      sbt[n * QT + j] = to_float(Bm[src]);
      sc[j * NS + n] = to_float(Cm[src]);
    }
    if (threadIdx.x < Q) sdt[threadIdx.x] = dt[(row0 + threadIdx.x) * d.H + h];
    __syncthreads();

    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += sdt[i] * a;
        scum[i] = s;
      }
    }
    __syncthreads();

    // the masked form: C_i . B_j, weighted, for j <= i only
    zero(acc);
    mac_tile(acc, t_att, sc, NS, 1, sbt, QT, N);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < t_att.nr) {
        const int i = row_of(t_att, r);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = t_att.col + q;
          satt[i * QS + j] =
              j <= i ? acc[r][q] * expf(scum[i] - scum[j]) * sdt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y_i = exp(cum_i) C_i h + sum_{j <= i} att[i][j] x_j
    if (t_y.nr > 0) {
      zero(acc);
      mac_tile(acc, t_y, sc, NS, 1, sh, P, N);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < t_y.nr) {
          const float e = expf(scum[row_of(t_y, r)]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] *= e;
        }
      }
      // att is 0 past each row's diagonal: stop after the last row's
      mac_tile(acc, t_y, satt, QS, 1, sx, P, row_of(t_y, t_y.nr - 1) + 1);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < t_y.nr) {
          T* out = y + ((row0 + row_of(t_y, r)) * d.H + h) * P + t_y.col;
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q] = from_float<T>(acc[r][q]);
        }
      }
    }
    __syncthreads();

    // x_j <- x_j dt_j exp(cum_Q - cum_j), the weights of the state update
    for (int e = threadIdx.x; e < Q * P; e += kThreads) {
      const int j = e / P;
      sx[e] *= sdt[j] * expf(scum[Q - 1] - scum[j]);
    }
    __syncthreads();

    // h <- exp(cum_Q) h + sum_j B_j^T x_j: each thread updates its own tile
    if (t_h.nr > 0) {
      const float decay = expf(scum[Q - 1]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < t_h.nr) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = decay * sh[row_of(t_h, r) * P + t_h.col + q];
        }
      }
      mac_tile(acc, t_h, sbt, QT, 1, sx, P, Q);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < t_h.nr) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sh[row_of(t_h, r) * P + t_h.col + q] = acc[r][q];
        }
      }
    }
    __syncthreads();
  }

  if (fin != nullptr)
    for (int e = threadIdx.x; e < N * P; e += kThreads)
      fin[state0 + e] = sh[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* init, void* y, float* fin,
           const Dims& d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)layout(d.Q, d.N, d.P).total;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_kernel<T><<<dim3(d.H, d.B), kThreads, smem, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, init, (T*)y, fin, d);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  init and final
// may be null.  Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init,
                        void* y, void* final_state, int B, int L, int H,
                        int G, int N, int P, int Q, int dtype, void* stream) {
  using namespace ssd;
  if (B < 1 || L < 1 || H < 1 || G < 1 || N < 1 || P < 1 || Q < 1 ||
      B > 65535 || L % Q != 0 || H % G != 0 || !fits(Q, Q) || !fits(Q, P) ||
      !fits(N, P) ||
      sizeof(float) * (size_t)layout(Q, N, P).total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Dims d{B, L, H, G, N, P, Q};
  cudaStream_t st = (cudaStream_t)stream;
  const float* dtf = (const float*)dt;
  const float* Af = (const float*)A;
  const float* in = (const float*)init;
  float* out = (float*)final_state;
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Bm, Cm, in, y, out, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, in, y, out, d, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
