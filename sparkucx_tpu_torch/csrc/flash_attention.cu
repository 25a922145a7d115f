// Flash attention for Hopper (sm_90a): the forward, dq and dk/dv kernels.
//
// Replaces the TPU kernels of sparkucx_tpu/ops/pallas/flash_attention.py:
//   flash_fwd  <- _fwd_kernel (via _fwd_pallas)
//   flash_dq   <- _dq_kernel  (via _bwd_pallas)
//   flash_dkv  <- _dkv_kernel (via _bwd_pallas)
// on q, k, v, g [BH, T, D] float32 (contiguous, 16-byte aligned) with
// lse, delta [BH, T] float32:
//   s     = scale * q k^T, masked to -1e30 where col >= T or (causal and
//           col > row)
//   O     = softmax(s) v, by the online-softmax recurrence over K tiles;
//           lse = m + log(l), and O = 0, lse = 0 for a row with no live key
//   p     = exp(s - lse) on live entries, 0 elsewhere
//   ds    = p * (g v^T - delta) * scale,  delta = rowsum(g * O)
//   dq    = ds k,   dk = ds^T q,   dv = p^T g
// The reference pads T to a block multiple; these kernels bounds-check
// instead (rows past T load as zeros, are masked and never stored).
//
// Bound: operations. At the main path's shape ([32, 32768, 128], causal)
// the forward needs 4 * D flops per live (q, k) pair and the backward 10 * D
// (FlashAttention-2's accounting), 8.8e12 and 2.2e13 flops, against about
// 2 GB of traffic: at the card's float32 rate outside the tensor cores
// (67 TFLOP/s) that is 131 ms and 328 ms, against 0.64 ms for the bytes.
// The design therefore keeps every operand of the inner products in
// shared memory and registers and reads each tile from device memory once
// per use; it computes in float32 on CUDA cores, as the reference does.
// Tensor cores (TF32 wgmma, TMA-fed pipelines) are later work.
//
// Design: 128 threads per block, 64-row Q and K tiles. Thread t owns rows
// 8 * (t / 16) .. +7 of a 64 x 64 score tile and its columns
// 4 * (t % 16) .. +3, so the 16 threads of one row group sit in one
// half-warp and a row's max and sum are shuffles within it. Tiles that the
// inner products walk along D are stored transposed ([D][64 + 4] floats),
// so a thread reads its 8 rows and 4 columns as three 16-byte loads per
// step of D; the 64 x 64 probability tile goes through shared memory,
// transposed, for the products with V, dO, K and Q, where a thread owns
// output columns t % 16 + 16 * c.
//   forward: one block per (bh, Q tile); the running max, sum and the O
//     accumulator stay in registers; K then V share one shared buffer;
//     causal K tiles above the diagonal are skipped.
//   dq: the same nest; dP = dO V^T first, then S = Q K^T with K kept for
//     dq += dS K.
//   dk/dv: one block per (bh, K tile) holding K and V, looping over the Q
//     tiles at or below the diagonal; P^T then dS^T pass through shared
//     memory for dv += P^T dO and dk += dS^T Q.
// Shared memory at D = 128: forward 87,040 B, dq 121,856 B, dk/dv
// 156,672 B; above the 48 KB default, so each launch opts in first.
// Blocks run heaviest first under causal masking (the longest K or Q
// loop), so the tail of the grid is short.
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;            // rows of a Q tile and of a K tile
constexpr int kThreads = 128;
constexpr int kLd = kB + 4;       // row of a transposed tile (16 B aligned)
constexpr int kRows = 8;          // score rows per thread
constexpr int kCols = 4;          // score columns per thread
constexpr float kNegInf = -1e30f;

template <int D>
struct Cols {
  static constexpr int kPer = (D + 15) / 16;   // output columns per thread
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows r0 .. r0 + 63 of a [T, D] row-major matrix into dst[d * kLd + r],
// times mul; rows past T load as zeros.
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* src, int r0,
                                       int T, float mul) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kB * kVec; e += kThreads) {
    const int r = e / kVec;
    const int d = (e % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) {
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * D + d);
    }
    dst[(d + 0) * kLd + r] = x.x * mul;
    dst[(d + 1) * kLd + r] = x.y * mul;
    dst[(d + 2) * kLd + r] = x.z * mul;
    dst[(d + 3) * kLd + r] = x.w * mul;
  }
}

// Rows r0 .. r0 + 63 into dst[r * D + d] (row-major).
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int T) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kB * kVec; e += kThreads) {
    const int r = e / kVec;
    const int d = (e % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) {
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * D + d);
    }
    *reinterpret_cast<float4*>(dst + r * D + d) = x;
  }
}

// s[i][j] += sum_d At[d][8 tr + i] * Bt[d][4 tc + j]
template <int D>
__device__ __forceinline__ void mm_tt(const float* At, const float* Bt,
                                      float (&s)[kRows][kCols]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* a_col = At + tr * kRows;
  const float* b_col = Bt + tc * kCols;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_col + d * kLd);
    const float4 a1 = *reinterpret_cast<const float4*>(a_col + d * kLd + 4);
    const float4 b4 = *reinterpret_cast<const float4*>(b_col + d * kLd);
    const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kCols] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
  }
}

// acc[i][c] += sum_k Pt[k][8 tr + i] * X(k, tc + 16 c), X(k, n) at
// X[k * sk + n * sn]
template <int D>
__device__ __forceinline__ void mm_pv(const float* Pt, const float* X, int sk,
                                      int sn,
                                      float (&acc)[kRows][Cols<D>::kPer]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* p_col = Pt + tr * kRows;
#pragma unroll 2
  for (int k = 0; k < kB; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(p_col + k * kLd);
    const float4 a1 = *reinterpret_cast<const float4*>(p_col + k * kLd + 4);
    const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int c = 0; c < Cols<D>::kPer; ++c) {
      const int n = tc + 16 * c;
      if (D % 16 == 0 || n < D) {
        const float x = X[k * sk + n * sn];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(a[i], x, acc[i][c]);
      }
    }
  }
}

// Rows of a [kB, D] accumulator to out (row-major [T, D]), rows < T.
template <int D>
__device__ __forceinline__ void store_rows(
    float* out, int r0, int T, float (&acc)[kRows][Cols<D>::kPer],
    float (&div)[kRows]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + tr * kRows + i;
    if (r >= T) continue;
#pragma unroll
    for (int c = 0; c < Cols<D>::kPer; ++c) {
      const int n = tc + 16 * c;
      if (D % 16 == 0 || n < D) out[(long long)r * D + n] = acc[i][c] / div[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int bh_count, int T, int causal,
          float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kLd], q * scale
  float* KV = Qt + D * kLd;                      // Kt [D][kLd] / V [kB][D]
  float* Pt = KV + D * kLd;                      // [kB][kLd]
  const int nt = (T + kB - 1) / kB;
  const int tile = nt - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = (long long)bh * T * D;
  const int q0 = tile * kB;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  load_t<D>(Qt, q + base, q0, T, scale);
  float acc[kRows][Cols<D>::kPer];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Cols<D>::kPer; ++c) acc[i][c] = 0.f;
  }
  const int nk = causal ? tile + 1 : nt;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kB;
    __syncthreads();                 // the last tile's V and P are spent
    load_t<D>(KV, k + base, k0, T, 1.f);
    __syncthreads();
    float s[kRows][kCols] = {};
    mm_tt<D>(Qt, KV, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + tr * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int col = k0 + tc * kCols + jj;
        if (col >= T || (causal && col > row)) s[i][jj] = kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const bool dead = m_new <= kNegInf / 2;
      const float m_safe = dead ? 0.f : m_new;
      const float alpha = dead ? 1.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float p = dead ? 0.f : expf(s[i][jj] - m_safe);
        s[i][jj] = p;
        sum += p;
      }
      sum = group_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < Cols<D>::kPer; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        Pt[(tc * kCols + jj) * kLd + tr * kRows + i] = s[i][jj];
      }
    }
    __syncthreads();                 // K reads done, P complete
    load_rows<D>(KV, v + base, k0, T);
    __syncthreads();
    mm_pv<D>(Pt, KV, D, 1, acc);
  }
  float denom[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) denom[i] = l[i] <= 0.f ? 1.f : l[i];
  store_rows<D>(o + base, q0, T, acc, denom);
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + tr * kRows + i;
      if (row < T) {
        lse[(long long)bh * T + row] =
            l[i] <= 0.f ? 0.f : m[i] + logf(denom[i]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ g,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dq, int bh_count, int T, int causal,
         float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kLd]
  float* Gt = Qt + D * kLd;                      // [D][kLd]
  float* KVt = Gt + D * kLd;                     // Vt, then Kt [D][kLd]
  float* St = KVt + D * kLd;                     // dS^T [kB][kLd]
  const int nt = (T + kB - 1) / kB;
  const int tile = nt - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = (long long)bh * T * D;
  const int q0 = tile * kB;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  load_t<D>(Qt, q + base, q0, T, 1.f);
  load_t<D>(Gt, g + base, q0, T, 1.f);
  float lr[kRows], dr[kRows], one[kRows];
  float acc[kRows][Cols<D>::kPer];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + tr * kRows + i;
    lr[i] = row < T ? lse[(long long)bh * T + row] : 0.f;
    dr[i] = row < T ? delta[(long long)bh * T + row] : 0.f;
    one[i] = 1.f;
#pragma unroll
    for (int c = 0; c < Cols<D>::kPer; ++c) acc[i][c] = 0.f;
  }
  const int nk = causal ? tile + 1 : nt;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kB;
    __syncthreads();                 // the last tile's K and dS are spent
    load_t<D>(KVt, v + base, k0, T, 1.f);
    __syncthreads();
    float dp[kRows][kCols] = {};
    mm_tt<D>(Gt, KVt, dp);
    __syncthreads();                 // V reads done
    load_t<D>(KVt, k + base, k0, T, 1.f);
    __syncthreads();
    float s[kRows][kCols] = {};
    mm_tt<D>(Qt, KVt, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + tr * kRows + i;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int col = k0 + tc * kCols + jj;
        const bool live = col < T && row < T && !(causal && col > row);
        const float p = live ? expf(scale * s[i][jj] - lr[i]) : 0.f;
        St[(tc * kCols + jj) * kLd + tr * kRows + i] =
            p * (dp[i][jj] - dr[i]) * scale;
      }
    }
    __syncthreads();                 // dS complete
    mm_pv<D>(St, KVt, 1, kLd, acc);  // K[k][n] at Kt[n][k]
  }
  store_rows<D>(dq + base, q0, T, acc, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dk, float* __restrict__ dv, int bh_count,
          int T, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [D][kLd]
  float* Vt = Kt + D * kLd;                      // [D][kLd]
  float* Qt = Vt + D * kLd;                      // [D][kLd]
  float* Gt = Qt + D * kLd;                      // [D][kLd]
  float* St = Gt + D * kLd;                      // P^T, then dS^T [kB][kLd]
  const int nt = (T + kB - 1) / kB;
  const int tile = static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = (long long)bh * T * D;
  const int k0 = tile * kB;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  load_t<D>(Kt, k + base, k0, T, 1.f);
  load_t<D>(Vt, v + base, k0, T, 1.f);
  float acc_k[kRows][Cols<D>::kPer], acc_v[kRows][Cols<D>::kPer];
  float one[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    one[i] = 1.f;
#pragma unroll
    for (int c = 0; c < Cols<D>::kPer; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }
  for (int j = causal ? tile : 0; j < nt; ++j) {
    const int q0 = j * kB;
    __syncthreads();                 // the last tile's Q, dO and dS are spent
    load_t<D>(Qt, q + base, q0, T, 1.f);
    load_t<D>(Gt, g + base, q0, T, 1.f);
    __syncthreads();
    float lq[kCols], dl[kCols];
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int qr = q0 + tc * kCols + jj;
      lq[jj] = qr < T ? lse[(long long)bh * T + qr] : 0.f;
      dl[jj] = qr < T ? delta[(long long)bh * T + qr] : 0.f;
    }
    {
      float s[kRows][kCols] = {};
      mm_tt<D>(Kt, Qt, s);           // s[i][jj]: key 8 tr + i, query 4 tc + jj
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int key = k0 + tr * kRows + i;
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const int qr = q0 + tc * kCols + jj;
          const bool live = key < T && qr < T && !(causal && key > qr);
          St[(tc * kCols + jj) * kLd + tr * kRows + i] =
              live ? expf(scale * s[i][jj] - lq[jj]) : 0.f;
        }
      }
    }
    float ds[kRows][kCols] = {};
    mm_tt<D>(Vt, Gt, ds);            // dP^T
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float p = St[(tc * kCols + jj) * kLd + tr * kRows + i];
        ds[i][jj] = p * (ds[i][jj] - dl[jj]) * scale;
      }
    }
    __syncthreads();                 // P^T complete
    mm_pv<D>(St, Gt, 1, kLd, acc_v); // dO[q][n] at Gt[n][q]
    __syncthreads();                 // P^T reads done
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        St[(tc * kCols + jj) * kLd + tr * kRows + i] = ds[i][jj];
      }
    }
    __syncthreads();                 // dS^T complete
    mm_pv<D>(St, Qt, 1, kLd, acc_k); // Q[q][n] at Qt[n][q]
  }
  store_rows<D>(dk + base, k0, T, acc_k, one);
  store_rows<D>(dv + base, k0, T, acc_v, one);
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool bad_grid(int bh, int T, long long* blocks) {
  if (bh <= 0 || T <= 0) return true;
  *blocks = (long long)((T + kB - 1) / kB) * bh;
  return *blocks > 0x7fffffffLL;
}

template <int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int bh, int T, int causal,
                       float scale, cudaStream_t s) {
  long long blocks;
  if (bad_grid(bh, T, &blocks)) return cudaErrorInvalidValue;
  const size_t smem = (2 * D * kLd + kB * kLd) * sizeof(float);
  cudaError_t e = opt_in(flash_fwd<D>, smem);
  if (e != cudaSuccess) return e;
  flash_fwd<D><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      q, k, v, o, lse, bh, T, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* g, const float* lse, const float* delta,
                      float* dq, int bh, int T, int causal, float scale,
                      cudaStream_t s) {
  long long blocks;
  if (bad_grid(bh, T, &blocks)) return cudaErrorInvalidValue;
  const size_t smem = (3 * D * kLd + kB * kLd) * sizeof(float);
  cudaError_t e = opt_in(flash_dq<D>, smem);
  if (e != cudaSuccess) return e;
  flash_dq<D><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      q, k, v, g, lse, delta, dq, bh, T, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* g, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int T, int causal,
                       float scale, cudaStream_t s) {
  long long blocks;
  if (bad_grid(bh, T, &blocks)) return cudaErrorInvalidValue;
  const size_t smem = (4 * D * kLd + kB * kLd) * sizeof(float);
  cudaError_t e = opt_in(flash_dkv<D>, smem);
  if (e != cudaSuccess) return e;
  flash_dkv<D><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      q, k, v, g, lse, delta, dk, dv, bh, T, causal, scale);
  return cudaGetLastError();
}

}  // namespace

#define SXT_HEAD_DIMS(X) X(8) X(16) X(32) X(64) X(128)

extern "C" int sxt_flash_fwd(const float* q, const float* k, const float* v,
                             float* o, float* lse, int bh, int T, int D,
                             int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define SXT_CASE(d) \
    case d: return static_cast<int>(                                   \
        launch_fwd<d>(q, k, v, o, lse, bh, T, causal, scale, s));
    SXT_HEAD_DIMS(SXT_CASE)
#undef SXT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sxt_flash_dq(const float* q, const float* k, const float* v,
                            const float* g, const float* lse,
                            const float* delta, float* dq, int bh, int T,
                            int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define SXT_CASE(d) \
    case d: return static_cast<int>(launch_dq<d>(                       \
        q, k, v, g, lse, delta, dq, bh, T, causal, scale, s));
    SXT_HEAD_DIMS(SXT_CASE)
#undef SXT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sxt_flash_dkv(const float* q, const float* k, const float* v,
                             const float* g, const float* lse,
                             const float* delta, float* dk, float* dv,
                             int bh, int T, int D, int causal, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define SXT_CASE(d) \
    case d: return static_cast<int>(launch_dkv<d>(                      \
        q, k, v, g, lse, delta, dk, dv, bh, T, causal, scale, s));
    SXT_HEAD_DIMS(SXT_CASE)
#undef SXT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
