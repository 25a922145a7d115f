// Ragged grouped GEMM for the transformer's expert FFN (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the expert products to
// XLA as one-hot einsums (sparkucx_tpu/models/transformer.py), and the
// port ran them as one-hot products over every received row, which put
// every row through every local expert: e_local times the capacity factor
// (8 at the Switch-Base-8 training cell) times the owned rows. Here each
// expert multiplies only the rows it owns. The rows arrive sorted by
// expert (models/transformer.py sorts them on the device), so expert j
// owns the contiguous rows [offsets[j], offsets[j] + counts[j]); both
// arrays stay on the device and every block reads them itself, so no host
// synchronisation is needed and every launch has a static grid.
//
// Two kernels, in float32 or bfloat16 storage with float32 FFMA sums on
// the CUDA cores (no tensor-core TF32: the training cell's gradient limit
// needs float32-accurate products; bf16 products are exact in float32, so
// bf16 inputs get bf16 products with float32 sums, as cuBLAS gives):
//
//   grouped_rows  c[r] = epi(a[r] . b[j])  for every row r expert j owns,
//                 b[j] a [K, N] matrix; epi is none, the tanh GELU (the
//                 product rounded to the storage type goes to `pre`, its
//                 GELU to c) or the GELU's derivative (the product, rounded
//                 to the storage type, times gelu'(pre[r])). The grid is a
//                 static upper bound of row tiles, ceil(R / 128) + groups;
//                 a block walks the counts to find its expert and its first
//                 row and returns at once past the live tiles. Rows of no
//                 expert are not touched.
//   grouped_wgrad c[j] = sum over the rows r expert j owns of
//                 a[r]^T b[r]: [M, N] per expert, the weight gradients; the
//                 reduction runs over the expert's ragged row count inside
//                 the block (an expert with no rows gets zeros).
//
// Bound: operations. At the training cell's shapes (16,384 owned rows a
// call, D 768, F 3,072) a forward is 2 * 2 * 16,384 * 768 * 3,072 =
// 154.6 GFLOP, the backward twice that; at the float32 CUDA-core rate of
// 67 TFLOP/s that is 2.31 ms forward and 4.62 ms backward a call, against
// about 0.3 GB of traffic (0.1 ms). Tile edges add at most groups * 127
// rows (about 6% there).
//
// Design: the classic SIMT SGEMM. 256 threads own a 128 x 128 output tile,
// 8 x 8 values a thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, and the
// same for columns, so each k step reads two float4 of A and two of B from
// shared memory for 64 FMAs); K advances 16 at a time through two shared
// stages, the next stage's global loads (two 16-byte loads of A and two of
// B a thread) in flight while the current stage is multiplied. grouped_rows
// stores its A tile transposed (k-major, rows padded by 4 floats, which
// puts the 32 stores of a warp on 32 banks); grouped_wgrad's A and B tiles
// are rows of the inputs already, k-major. Global loads need the row
// strides and the inner dims to be multiples of 4 elements and 16-byte (8
// for bf16) aligned bases; the wrapper checks. On an H100 (700 W) at the
// training cell's shapes, 16-deep stages ran the row products at 42 TFLOP/s
// against 36 for 8-deep ones and the weight gradients 5% faster; 255
// registers with one block an SM, or warp-shaped 32 x 64 thread tiles, were
// slower.
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers and the current stream, and raises on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kAPad = 4;
constexpr int kChunks = kBK / 8;   // 8-deep slices a thread loads a stage

enum Epilogue : int { kNone = 0, kGelu = 1, kGeluGrad = 2 };

// torch's tanh GELU and its derivative, in float32 (opmath) arithmetic
constexpr float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float kKappa = 0.044715f;

__device__ __forceinline__ float gelu(float x) {
  const float inner = kBeta * (x + kKappa * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float x_sq = x * x;
  const float inner = kBeta * (x + kKappa * x_sq * x);
  const float t = tanhf(inner);
  const float left = 0.5f * x;
  const float left_d = 0.5f * (1.0f + t);
  const float right_d = left * (1.0f - t * t) * kBeta *
                        (1.0f + 3.0f * kKappa * x_sq);
  return left_d + right_d;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// a float32 value rounded to the storage type T and back
__device__ __forceinline__ float4 rounded(float4 v, const float*) {
  return v;
}

__device__ __forceinline__ float4 rounded(float4 v, const __nv_bfloat16*) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

// One k stage of the 128 x 128 tile: acc += As[kk]^T Bs[kk] for kk < 16,
// the thread's rows at ty*4 and 64 + ty*4, its columns at tx*4 and 64 +
// tx*4 (a_stride: floats between consecutive k rows of As).
template <int kAStride>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          int ty, int tx,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(
        As + kk * kAStride + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(
        As + kk * kAStride + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(
        Bs + kk * kBN + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(
        Bs + kk * kBN + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ int tile_row(int i, int ty) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

// The expert, first row and live row count of row tile `tile`: tiles are
// numbered expert after expert, ceil(counts[j] / 128) of them for expert
// j. False past the last live tile.
__device__ __forceinline__ bool find_row_tile(const int* __restrict__ counts,
                                              const int* __restrict__ offsets,
                                              int groups, int tile, int& g,
                                              int& row0, int& rows) {
  int base = 0;
  for (int j = 0; j < groups; ++j) {
    const int c = counts[j];
    const int nt = (c + kBM - 1) / kBM;
    if (tile < base + nt) {
      const int t = tile - base;
      g = j;
      row0 = offsets[j] + t * kBM;
      rows = min(kBM, c - t * kBM);
      return true;
    }
    base += nt;
  }
  return false;
}

template <typename T, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
grouped_rows(const T* __restrict__ a, long long lda, const T* __restrict__ b,
             long long b_group, long long ldb, T* __restrict__ c,
             long long ldc, T* __restrict__ pre, long long ldp,
             const int* __restrict__ counts, const int* __restrict__ offsets,
             int groups, int K, int N) {
  int g, row0, rows;
  if (!find_row_tile(counts, offsets, groups, blockIdx.y, g, row0, rows)) {
    return;
  }
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  __shared__ __align__(16) float As[2][kBK][kBM + kAPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  // A: row tid / 2, k (tid % 2) * 4 + 8c of the stage; B: k tid / 32 + 8c,
  // column (tid % 32) * 4, for c < 2
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  const bool a_ok = a_row < rows;
  const bool b_ok = n0 + b_n < N;
  const T* a_ptr = a + (long long)(row0 + a_row) * lda + a_k;
  const T* b_ptr = b + (long long)g * b_group + (long long)b_k * ldb + n0 +
                   b_n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 ra[kChunks], rb[kChunks];
  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = k0 + 8 * c;
      ra[c] = (a_ok && k + a_k < K) ? load4(a_ptr + k) : zero;
      rb[c] = (b_ok && k + b_k < K) ? load4(b_ptr + (long long)k * ldb)
                                    : zero;
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      As[s][8 * c + a_k + 0][a_row] = ra[c].x;
      As[s][8 * c + a_k + 1][a_row] = ra[c].y;
      As[s][8 * c + a_k + 2][a_row] = ra[c].z;
      As[s][8 * c + a_k + 3][a_row] = ra[c].w;
      *reinterpret_cast<float4*>(&Bs[s][8 * c + b_k][b_n]) = rb[c];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * kBK);
    mma_stage<kBM + kAPad>(&As[s][0][0], &Bs[s][0][0], ty, tx, acc);
    if (more) stash(s ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(i, ty);
    if (r >= rows) continue;
    const long long row = row0 + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= N) continue;
      float4 v = make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1],
                             acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      if (kEpi == kGelu) {
        v = rounded(v, a);
        store4(pre + row * ldp + col, v);
        v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
      } else if (kEpi == kGeluGrad) {
        v = rounded(v, a);
        const float4 p = load4(pre + row * ldp + col);
        v = make_float4(v.x * gelu_grad(p.x), v.y * gelu_grad(p.y),
                        v.z * gelu_grad(p.z), v.w * gelu_grad(p.w));
      }
      store4(c + row * ldc + col, v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
grouped_wgrad(const T* __restrict__ a, long long lda, const T* __restrict__ b,
              long long ldb, T* __restrict__ c, long long c_group,
              const int* __restrict__ counts, const int* __restrict__ offsets,
              int M, int N) {
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = counts[g];
  const long long r0 = offsets[g];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  // both tiles: k (a row of the inputs) tid / 32 + 8c, column (tid % 32)
  // * 4, for c < 2
  const int lk = tid >> 5, lc = (tid & 31) * 4;
  const bool a_ok = m0 + lc < M;
  const bool b_ok = n0 + lc < N;
  const T* a_ptr = a + (r0 + lk) * lda + m0 + lc;
  const T* b_ptr = b + (r0 + lk) * ldb + n0 + lc;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 ra[kChunks], rb[kChunks];
  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = k0 + 8 * c;
      const bool live = k + lk < rows;
      ra[c] = (a_ok && live) ? load4(a_ptr + (long long)k * lda) : zero;
      rb[c] = (b_ok && live) ? load4(b_ptr + (long long)k * ldb) : zero;
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      *reinterpret_cast<float4*>(&As[s][8 * c + lk][lc]) = ra[c];
      *reinterpret_cast<float4*>(&Bs[s][8 * c + lk][lc]) = rb[c];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int nk = (rows + kBK - 1) / kBK;
  if (nk > 0) {
    load(0);
    stash(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * kBK);
    mma_stage<kBM>(&As[s][0][0], &Bs[s][0][0], ty, tx, acc);
    if (more) stash(s ^ 1);
    __syncthreads();
  }

  T* cg = c + (long long)g * c_group;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_row(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= N) continue;
      store4(cg + (long long)m * N + col,
             make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1],
                         acc[i][h * 4 + 2], acc[i][h * 4 + 3]));
    }
  }
}

template <typename T>
cudaError_t launch_rows(const void* a, long long lda, const void* b,
                        long long b_group, long long ldb, void* c,
                        long long ldc, void* pre, long long ldp,
                        const int* counts, const int* offsets, int groups,
                        int row_tiles, int K, int N, int epi,
                        cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, row_tiles);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* tc = static_cast<T*>(c);
  T* tp = static_cast<T*>(pre);
  switch (epi) {
    case kNone:
      grouped_rows<T, kNone><<<grid, kThreads, 0, s>>>(
          ta, lda, tb, b_group, ldb, tc, ldc, tp, ldp, counts, offsets,
          groups, K, N);
      break;
    case kGelu:
      grouped_rows<T, kGelu><<<grid, kThreads, 0, s>>>(
          ta, lda, tb, b_group, ldb, tc, ldc, tp, ldp, counts, offsets,
          groups, K, N);
      break;
    case kGeluGrad:
      grouped_rows<T, kGeluGrad><<<grid, kThreads, 0, s>>>(
          ta, lda, tb, b_group, ldb, tc, ldc, tp, ldp, counts, offsets,
          groups, K, N);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* a, long long lda, const void* b,
                         long long ldb, void* c, const int* counts,
                         const int* offsets, int groups, int M, int N,
                         cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, groups);
  grouped_wgrad<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb,
      static_cast<T*>(c), (long long)M * N, counts, offsets, M, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sxt_grouped_rows(const void* a, long long lda, const void* b,
                                long long b_group, long long ldb, void* c,
                                long long ldc, void* pre, long long ldp,
                                const void* counts, const void* offsets,
                                int groups, int row_tiles, int K, int N,
                                int epi, int bf16, void* stream) {
  if (row_tiles <= 0 || N <= 0 || K < 0 || groups <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ct = static_cast<const int*>(counts);
  const int* of = static_cast<const int*>(offsets);
  const cudaError_t rc =
      bf16 ? launch_rows<__nv_bfloat16>(a, lda, b, b_group, ldb, c, ldc, pre,
                                        ldp, ct, of, groups, row_tiles, K, N,
                                        epi, s)
           : launch_rows<float>(a, lda, b, b_group, ldb, c, ldc, pre, ldp,
                                ct, of, groups, row_tiles, K, N, epi, s);
  return static_cast<int>(rc);
}

extern "C" int sxt_grouped_wgrad(const void* a, long long lda, const void* b,
                                 long long ldb, void* c, const void* counts,
                                 const void* offsets, int groups, int M,
                                 int N, int bf16, void* stream) {
  if (M <= 0 || N <= 0 || groups <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ct = static_cast<const int*>(counts);
  const int* of = static_cast<const int*>(offsets);
  const cudaError_t rc =
      bf16 ? launch_wgrad<__nv_bfloat16>(a, lda, b, ldb, c, ct, of, groups,
                                         M, N, s)
           : launch_wgrad<float>(a, lda, b, ldb, c, ct, of, groups, M, N, s);
  return static_cast<int>(rc);
}
