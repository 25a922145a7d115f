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
// (FlashAttention-2's accounting: 2 * D in dq's product, 8 * D in dk/dv's
// S, dP, dV and dK), 8.8e12 and 2.2e13 flops, against about 2 GB of
// traffic (0.64 ms). Float32-accurate products on the tensor cores take
// three TF32 products each (split-TF32, below), so their rate is a third
// of TF32's 495 TFLOP/s: 165 TFLOP/s, and the bounds are 53.3 ms forward,
// 26.7 ms dq and 106.6 ms dk/dv (at the float32 rate outside the tensor
// cores, 67 TFLOP/s: 131, 66 and 263 ms). The kernels recompute S and dP
// (dq does 6 * D per pair, dk/dv 8 * D), as the reference's do.
//
// All three kernels take every product on the tensor cores with mma.sync
// m16n8k8 TF32, in split-TF32 (3xTF32, the scheme of CUTLASS's fast float32
// products that PyTorch's memory-efficient SDPA uses): each operand x is
// split in registers, at its fragment load, into big = x rounded to TF32
// and small = x - big, which the tensor core reads truncated to TF32, and
// a b = a_big b_big + a_small b_big + a_big b_small. The tensor core cuts
// each sum into its accumulator toward zero, so products added into a large
// running sum lose their low bits the same way each time: the cross terms
// of dP (where dS = P (dP - delta) cancels when a gradient vanishes) and of
// the forward's S go to an accumulator of their own, and the forward's O
// and dq sum each streamed tile's products from zero before one rounded
// float32 addition. dk/dv has
// no registers to spare for that and adds straight into its accumulators,
// so dk and dv drift further from float32 sums as T grows (at the main
// shape about 100 times SDPA's distance from the plain version, a fifth of
// the tolerance). Scale, exp, masks, the online softmax and dS stay float32
// on CUDA cores. FlashAttention-2's layout: 256 threads, 8 warps that each
// own 16 rows of a resident 128-row tile (Q in the forward; Q and dO in dq;
// K and V in dk/dv), streaming 32-row tiles of the other side (K and V; Q,
// dO, lse and delta; the forward 64-row tiles of K and V) through a
// two-stage ring of 16-byte cp.async copies, so tile j + 1 lands while
// tile j is multiplied; 4 warps a block would leave one warp to each of
// the SM's schedulers. A fragments and the B fragments of S and dP load
// with ldmatrix. S and P (S^T and P^T) stay in
// accumulator registers: an accumulator tile serves as the A operand of the
// next product when that product's B rows are taken in the order 2t,
// 2t + 1 (load_b_perm), so no value moves between lanes. Shared rows are
// D + 4 floats, which puts every fragment load on 32 distinct banks. One
// block per (bh, 128-row tile); the forward and dq own Q rows and loop over
// the K tiles at or below them, dk/dv owns K rows and loops over the Q
// tiles at or after them; each output element has one writer and no
// atomics, so two launches give the same bits. Under the causal mask a warp
// skips a streamed tile that lies wholly on the masked side of its 16 rows,
// masks are applied only on tiles that cross the diagonal or the T edge,
// and blocks run heaviest first.
//
// Forward (flash_fwd): the resident Q tile is multiplied by scale in
// float32 once it lands, as the reference scales q before its product;
// per 64-key stage S = (q scale) K^T with its cross terms summed apart,
// then the online softmax (running max m and sum l of rows g and g + 8 in
// each lane, quad shuffles for a row's max and sum, the reference's
// dead-row rule), acc *= alpha, and O += P V with P as the A operand in
// place, each 32-key half summed from zero. 64-row stages (against 32)
// halve the barriers and Q's fragment loads per key: 10% less time.
// Shared memory at D = 128: forward, dq 202,752 B, dk/dv 203,264 B, one
// block per SM; all opt in above 48 KB.
//
// Measured at [32, 32768, 128] causal (flash_bench.py on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit): forward 162.7 ms against 182.2 ms for
// SDPA's float32 forward in the same run (the float32 CUDA-core kernel it
// replaces: 355.5 ms); dq 240.2 ms and dk/dv 304.3 ms, 544.5 ms together
// against 576.2 ms for SDPA's float32 backward; 33%, 11% and 35% of their
// split-TF32 bounds. PERF.md's kernel table has the rest.
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// -- split-TF32 products on the tensor cores ----------------------------------
// mma.sync m16n8k8 (TF32 in, float32 accumulate). Fragments, with
// g = lane / 4 and t = lane % 4: A (16 x 8, row-major) holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) holds (t, g) and
// (t + 4, g); the accumulator C (16 x 8) holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). The tensor core reads a TF32 operand from
// a 32-bit register and ignores its low 13 bits.

constexpr int kThreads = 256;     // 8 warps, 16 resident rows each
constexpr int kRes = 128;         // resident rows: Q (forward, dq), K and V
                                  // (dk/dv)
constexpr int kStr = 32;          // streamed rows a stage: K and V (dq; the
                                  // forward takes two), Q and dO (dk/dv)

// Row-major tiles: rows of D + 4 floats. The pad of 4 puts the 32 lanes of
// every fragment load below on 32 distinct banks.
template <int D>
struct RowTile {
  static constexpr int kLd = D + 4;
};

// x = big + small: big = x rounded to TF32 (to nearest, ties away from
// zero: adding half of the dropped unit before the tensor core truncates),
// small = x - big, which the tensor core truncates to TF32; |x - big -
// small| <= 2^-21 |x|. The split happens at the fragment load, in
// registers, in three integer/float operations.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in split-TF32 (3xTF32): the two cross terms, then big * big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// The tensor core cuts each sum it adds into an accumulator toward zero,
// so products added into a large running sum lose their low bits, the
// same way each time. Two remedies, one for each kind of sum:
// dP, where dS = P (dP - delta) cancels when a gradient vanishes, and the
// forward's S, which sets lse, sum their cross terms in an accumulator of
// their own (dP = hi + lo) ...
__device__ __forceinline__ void mma3_lo(float (&hi)[4], float (&lo)[4],
                                        const FragA& a, const FragB& b) {
  mma_tf32(lo, a.small, b.big);
  mma_tf32(lo, a.big, b.small);
  mma_tf32(hi, a.big, b.big);
}

// ... and O and dQ, summed over every streamed tile, take each tile's
// products from zero and add them to their running sums with one rounded
// float32 addition (add_tile_product, below). dK and dV add straight into
// theirs (flash_dkv says why), so their distance from float32 sums grows
// with T.

__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// ldmatrix moves four 8 x 8 blocks of 16-bit values, each 8 x 4 of 32-bit
// ones, lane l receiving block i's (l / 4, l % 4) in r[i] as m16n8k8's TF32
// fragments hold them; lanes 8i .. 8i + 7 address block i's rows.
// A: rows m0 .. m0 + 15, columns k0 .. k0 + 7 of a row-major tile
template <int Ld>
__device__ __forceinline__ FragA load_a(const float* x, int m0, int k0,
                                        int lane) {
  const int blk = lane >> 3;
  uint32_t r[4];
  ldsm_x4(x + (m0 + (lane & 7) + (blk & 1) * 8) * Ld + k0 + (blk >> 1) * 4,
          r);
  return frag_a(__uint_as_float(r[0]), __uint_as_float(r[1]),
                __uint_as_float(r[2]), __uint_as_float(r[3]));
}

// B[k][n] = x[n0 + n][k0 + k] for two adjacent column blocks (n0 and
// n0 + 8): the tile's rows are the product's columns (S = Q K^T takes K so)
template <int Ld>
__device__ __forceinline__ void load_b_t2(const float* x, int n0, int k0,
                                          int lane, FragB& b0, FragB& b1) {
  const int blk = lane >> 3;
  uint32_t r[4];
  ldsm_x4(x + (n0 + (lane & 7) + (blk >> 1) * 8) * Ld + k0 + (blk & 1) * 4,
          r);
  b0 = frag_b(__uint_as_float(r[0]), __uint_as_float(r[1]));
  b1 = frag_b(__uint_as_float(r[2]), __uint_as_float(r[3]));
}

// B[k][n] = x[k0 + perm(k)][n0 + n] with perm(t) = 2t, perm(t + 4) = 2t + 1:
// the row order that lets an accumulator tile serve as A (frag_acc)
template <int Ld>
__device__ __forceinline__ FragB load_b_perm(const float* x, int k0, int n0,
                                             int g, int t) {
  const float* p = x + (k0 + 2 * t) * Ld + n0 + g;
  return frag_b(p[0], p[Ld]);
}

// An accumulator tile (16 x 8 of C) as the A operand of a product over its
// 8 columns, in load_b_perm's order: no data moves between lanes
__device__ __forceinline__ FragA frag_acc(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// acc (16 x D) += c x[0 .. kStr - 1][0 .. D - 1], where c (16 x kStr) is a
// tile of accumulators serving as A: each 16 x 8 output block sums the
// tile's kStr / 8 steps from zero and is then added to acc
template <int D, int Ld>
__device__ __forceinline__ void add_tile_product(
    float (&acc)[D / 8][4], const float (&c)[kStr / 8][4], const float* x,
    int g, int t) {
  FragA a[kStr / 8];
#pragma unroll
  for (int kk = 0; kk < kStr / 8; ++kk) a[kk] = frag_acc(c[kk]);
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    float sum[4] = {};
#pragma unroll
    for (int kk = 0; kk < kStr / 8; ++kk) {
      mma3(sum, a[kk], load_b_perm<Ld>(x, 8 * kk, 8 * nn, g, t));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] += sum[e];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + R - 1 of a [T, D] row-major matrix into a RowTile, as
// 16-byte asynchronous copies; rows past T fill with zeros.
template <int D, int R>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int r0, int T) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < R * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e % kVec) * 4;
    const bool in = r0 + r < T;
    cp_async16(dst + r * RowTile<D>::kLd + c,
               src + (long long)(in ? r0 + r : 0) * D + c, in);
  }
}

// x *= mul over a RowTile of R rows that stage_tile filled: each thread
// scales the 16-byte chunks it copied itself, which cp.async.wait_group has
// made visible to it, so no barrier comes between.
template <int D, int R>
__device__ __forceinline__ void scale_tile(float* x, float mul) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < R * kVec; e += kThreads) {
    float4* p = reinterpret_cast<float4*>(x + (e / kVec) * RowTile<D>::kLd +
                                          (e % kVec) * 4);
    float4 y = *p;
    y.x *= mul;
    y.y *= mul;
    y.z *= mul;
    y.w *= mul;
    *p = y;
  }
}

// Entries r0 .. r0 + R - 1 of two [T] rows (lse, delta) into a[] and b[];
// zeros past T.
template <int R>
__device__ __forceinline__ void stage_entries(float* a, const float* src_a,
                                              float* b, const float* src_b,
                                              int r0, int T) {
  const int r = threadIdx.x & (R - 1);
  if (threadIdx.x < 2 * R) {
    const bool in = r0 + r < T;
    const long long at = in ? r0 + r : 0;
    if (threadIdx.x < R) {
      cp_async4(a + r, src_a + at, in);
    } else {
      cp_async4(b + r, src_b + at, in);
    }
  }
}

// Rows r and r + 8 of a warp's [16, D] accumulator to out (row-major
// [T, D]), rows < T.
template <int D>
__device__ __forceinline__ void store_acc(float* out, int r, int T,
                                          const float (&acc)[D / 8][4],
                                          int t) {
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    const int col = 8 * nn + 2 * t;
    if (r < T) {
      *reinterpret_cast<float2*>(out + (long long)r * D + col) =
          make_float2(acc[nn][0], acc[nn][1]);
    }
    if (r + 8 < T) {
      *reinterpret_cast<float2*>(out + (long long)(r + 8) * D + col) =
          make_float2(acc[nn][2], acc[nn][3]);
    }
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {  // Q, two stages of 64-row K and V
  return (kRes + 8 * kStr) * RowTile<D>::kLd * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {   // Q, dO, two stages of K and V
  return (2 * kRes + 4 * kStr) * RowTile<D>::kLd * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, two stages of Q, dO, lse, delta
  return ((2 * kRes + 4 * kStr) * RowTile<D>::kLd + 4 * kStr) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int bh_count, int T, int causal,
          float scale) {
  constexpr int kRow = RowTile<D>::kLd, kN = D / 8;
  constexpr int kKeys = 2 * kStr;                // streamed rows a stage
  constexpr int kKeyTile = kKeys * kRow;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // resident Q tile, * scale
  float* ring = Qs + kRes * kRow;                // 2 stages of K, V
  const int nt = (T + kRes - 1) / kRes;
  const int tile = nt - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = (long long)bh * T * D;
  const int q0 = tile * kRes;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;        // the warp's Q rows
  const int row0 = q0 + m0 + gr, row1 = row0 + 8;

  stage_tile<D, kRes>(Qs, q + base, q0, T);
  cp_commit();
  stage_tile<D, kKeys>(ring, k + base, 0, T);
  stage_tile<D, kKeys>(ring + kKeyTile, v + base, 0, T);
  cp_commit();
  cp_wait<1>();                      // Q has landed: q * scale in float32,
  scale_tile<D, kRes>(Qs, scale);    // before any product, as the reference
  float acc[kN][4] = {};
  // running max and sum of rows gr (h = 0) and gr + 8 (h = 1)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // keys at or below the tile's last row under the causal mask
  const int kend = causal ? min(T, q0 + kRes) : T;
  const int nk = (kend + kKeys - 1) / kKeys;
  const bool rows_in = q0 + m0 < T;  // else the warp has nothing to store
  for (int j = 0; j < nk; ++j) {
    const float* Ks = ring + (j & 1) * 2 * kKeyTile;
    const float* Vs = Ks + kKeyTile;
    if (j + 1 < nk) {                // tile j + 1 in flight during tile j
      float* nxt = ring + ((j + 1) & 1) * 2 * kKeyTile;
      stage_tile<D, kKeys>(nxt, k + base, (j + 1) * kKeys, T);
      stage_tile<D, kKeys>(nxt + kKeyTile, v + base, (j + 1) * kKeys, T);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = j * kKeys;
    // a warp whose rows all lie above this tile's keys has nothing to add
    if (rows_in && (!causal || k0 <= q0 + m0 + 15)) {
      // S = (Q scale) K^T, the warp's 16 rows by 64 keys in two halves of
      // 32 (s[c]: keys k0 + 32c ..), cross terms summed apart
      float s[2][kStr / 8][4] = {}, lo[2][kStr / 8][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < kN; ++kk) {
        const FragA qa = load_a<kRow>(Qs, m0, 8 * kk, lane);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int nn = 0; nn < kStr / 8; nn += 2) {
            FragB kb[2];
            load_b_t2<kRow>(Ks, kStr * c + 8 * nn, 8 * kk, lane, kb[0],
                            kb[1]);
            mma3_lo(s[c][nn], lo[c][nn], qa, kb[0]);
            mma3_lo(s[c][nn + 1], lo[c][nn + 1], qa, kb[1]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int nn = 0; nn < kStr / 8; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][nn][e] += lo[c][nn][e];
        }
      }
      // masks only on a tile that crosses the T edge or the warp's diagonal
      if (k0 + kKeys > T || (causal && k0 + kKeys - 1 > q0 + m0)) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int nn = 0; nn < kStr / 8; ++nn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = e < 2 ? row0 : row1;
              const int col = k0 + kStr * c + 8 * nn + 2 * tc + (e & 1);
              if (col >= T || (causal && col > row)) s[c][nn][e] = kNegInf;
            }
          }
        }
      }
      // the online softmax over S's registers: row gr + 8h holds entries
      // 2h and 2h + 1 of each column block, its other columns sit in the
      // three other lanes of the quad
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int nn = 0; nn < kStr / 8; ++nn) {
            mx = fmaxf(mx, fmaxf(s[c][nn][2 * h], s[c][nn][2 * h + 1]));
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx);
        const bool dead = m_new <= kNegInf / 2;   // no live key yet
        const float m_safe = dead ? 0.f : m_new;
        alpha[h] = dead ? 1.f : expf(m_run[h] - m_safe);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int nn = 0; nn < kStr / 8; ++nn) {
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const float p = dead ? 0.f : expf(s[c][nn][e] - m_safe);
              s[c][nn][e] = p;
              sum += p;
            }
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[h] = l_run[h] * alpha[h] + sum;
        m_run[h] = m_new;
      }
#pragma unroll
      for (int nn = 0; nn < kN; ++nn) {
        acc[nn][0] *= alpha[0];
        acc[nn][1] *= alpha[0];
        acc[nn][2] *= alpha[1];
        acc[nn][3] *= alpha[1];
      }
      add_tile_product<D, kRow>(acc, s[0], Vs, gr, tc);   // O += P V
      // the second half lies wholly above the warp's rows on the diagonal
      if (!causal || k0 + kStr <= q0 + m0 + 15) {
        add_tile_product<D, kRow>(acc, s[1], Vs + kStr * kRow, gr, tc);
      }
    }
    __syncthreads();                 // this stage is free for tile j + 2
  }
  // O = acc / l and lse = m + log(l); a row with no live key (l = 0) gets
  // O = 0 and lse = 0, as the reference's
  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) denom[h] = l_run[h] <= 0.f ? 1.f : l_run[h];
#pragma unroll
  for (int nn = 0; nn < kN; ++nn) {
    acc[nn][0] /= denom[0];
    acc[nn][1] /= denom[0];
    acc[nn][2] /= denom[1];
    acc[nn][3] /= denom[1];
  }
  store_acc<D>(o + base, row0, T, acc, tc);
  if (tc == 0) {
    const long long rbase = (long long)bh * T;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row1 : row0;
      if (row < T) {
        lse[rbase + row] =
            l_run[h] <= 0.f ? 0.f : m_run[h] + logf(denom[h]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ g,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dq, int bh_count, int T, int causal,
         float scale) {
  constexpr int kRow = RowTile<D>::kLd, kN = D / 8;
  constexpr int kStrTile = kStr * kRow;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // resident Q tile
  float* Gs = Qs + kRes * kRow;                  // resident dO tile
  float* ring = Gs + kRes * kRow;                // 2 stages of K, V
  const int nt = (T + kRes - 1) / kRes;
  const int tile = nt - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = (long long)bh * T * D;
  const int q0 = tile * kRes;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;        // the warp's Q rows
  const int row0 = q0 + m0 + gr, row1 = row0 + 8;
  const long long rbase = (long long)bh * T;
  const float l0 = row0 < T ? lse[rbase + row0] : 0.f;
  const float l1 = row1 < T ? lse[rbase + row1] : 0.f;
  const float d0 = row0 < T ? delta[rbase + row0] : 0.f;
  const float d1 = row1 < T ? delta[rbase + row1] : 0.f;

  stage_tile<D, kRes>(Qs, q + base, q0, T);
  stage_tile<D, kRes>(Gs, g + base, q0, T);
  stage_tile<D, kStr>(ring, k + base, 0, T);
  stage_tile<D, kStr>(ring + kStrTile, v + base, 0, T);
  cp_commit();
  float acc[kN][4] = {};
  // keys at or below the tile's last row under the causal mask
  const int kend = causal ? min(T, q0 + kRes) : T;
  const int nk = (kend + kStr - 1) / kStr;
  for (int j = 0; j < nk; ++j) {
    const float* Ks = ring + (j & 1) * 2 * kStrTile;
    const float* Vs = Ks + kStrTile;
    if (j + 1 < nk) {                // tile j + 1 in flight during tile j
      float* nxt = ring + ((j + 1) & 1) * 2 * kStrTile;
      stage_tile<D, kStr>(nxt, k + base, (j + 1) * kStr, T);
      stage_tile<D, kStr>(nxt + kStrTile, v + base, (j + 1) * kStr, T);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = j * kStr;
    // a warp whose rows all lie above this tile's keys has nothing to add
    if (!causal || k0 <= q0 + m0 + 15) {
      // S = Q K^T and dP = dO V^T, the warp's 16 rows by 32 keys
      float s[kStr / 8][4] = {}, dp[kStr / 8][4] = {};
      float lo[kStr / 8][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kN; ++kk) {
        const FragA qa = load_a<kRow>(Qs, m0, 8 * kk, lane);
        const FragA ga = load_a<kRow>(Gs, m0, 8 * kk, lane);
#pragma unroll
        for (int nn = 0; nn < kStr / 8; nn += 2) {
          FragB kb[2], vb[2];
          load_b_t2<kRow>(Ks, 8 * nn, 8 * kk, lane, kb[0], kb[1]);
          load_b_t2<kRow>(Vs, 8 * nn, 8 * kk, lane, vb[0], vb[1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma3(s[nn + h], qa, kb[h]);
            mma3_lo(dp[nn + h], lo[nn + h], ga, vb[h]);
          }
        }
      }
      // dS = P (dP - delta) scale, over S's registers
#pragma unroll
      for (int nn = 0; nn < kStr / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + 8 * nn + 2 * tc + (e & 1);
          const bool live = col < T && row < T && !(causal && col > row);
          const float p =
              live ? expf(scale * s[nn][e] - (e < 2 ? l0 : l1)) : 0.f;
          s[nn][e] = p * (dp[nn][e] + lo[nn][e] - (e < 2 ? d0 : d1)) * scale;
        }
      }
      add_tile_product<D, kRow>(acc, s, Ks, gr, tc);  // dQ += dS K
    }
    __syncthreads();                 // this stage is free for tile j + 2
  }
  store_acc<D>(dq + base, row0, T, acc, tc);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dk, float* __restrict__ dv, int bh_count,
          int T, int causal, float scale) {
  constexpr int kRow = RowTile<D>::kLd, kN = D / 8;
  constexpr int kStrTile = kStr * kRow;
  constexpr int kStage = 2 * kStrTile + 2 * kStr;  // Q, dO, lse, delta
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // resident K tile
  float* Vs = Ks + kRes * kRow;                  // resident V tile
  float* ring = Vs + kRes * kRow;                // 2 stages
  const int tile = static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = (long long)bh * T * D;
  const long long rbase = (long long)bh * T;
  const int k0 = tile * kRes;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;        // the warp's keys
  const int key0 = k0 + m0 + gr, key1 = key0 + 8;

  auto stage = [&](int j, float* dst) {
    stage_tile<D, kStr>(dst, q + base, j * kStr, T);
    stage_tile<D, kStr>(dst + kStrTile, g + base, j * kStr, T);
    stage_entries<kStr>(dst + 2 * kStrTile, lse + rbase,
                          dst + 2 * kStrTile + kStr, delta + rbase,
                          j * kStr, T);
  };
  // queries at or after the tile's first key under the causal mask
  const int first = causal ? k0 / kStr : 0;
  const int nq = (T + kStr - 1) / kStr;
  stage_tile<D, kRes>(Ks, k + base, k0, T);
  stage_tile<D, kRes>(Vs, v + base, k0, T);
  stage(first, ring);
  cp_commit();
  float acc_k[kN][4] = {}, acc_v[kN][4] = {};
  for (int j = first; j < nq; ++j) {
    const int it = j - first;
    const float* Qs = ring + (it & 1) * kStage;
    const float* Gs = Qs + kStrTile;
    const float* Ls = Gs + kStrTile;
    const float* Ds = Ls + kStr;
    if (j + 1 < nq) {                // tile j + 1 in flight during tile j
      stage(j + 1, ring + ((it + 1) & 1) * kStage);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = j * kStr;
    // a warp whose keys all lie after this tile's queries has nothing to add
    if (!causal || k0 + m0 <= q0 + kStr - 1) {
      // S^T = K Q^T and dP^T = V dO^T, the warp's 16 keys by 32 queries
      float s[kStr / 8][4] = {}, dp[kStr / 8][4] = {};
      float lo[kStr / 8][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kN; ++kk) {
        const FragA ka = load_a<kRow>(Ks, m0, 8 * kk, lane);
        const FragA va = load_a<kRow>(Vs, m0, 8 * kk, lane);
#pragma unroll
        for (int nn = 0; nn < kStr / 8; nn += 2) {
          FragB qb[2], gb[2];
          load_b_t2<kRow>(Qs, 8 * nn, 8 * kk, lane, qb[0], qb[1]);
          load_b_t2<kRow>(Gs, 8 * nn, 8 * kk, lane, gb[0], gb[1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma3(s[nn + h], ka, qb[h]);
            mma3_lo(dp[nn + h], lo[nn + h], va, gb[h]);
          }
        }
      }
      // P^T over S^T's registers, dS^T = P^T (dP^T - delta) scale over
      // dP^T's
#pragma unroll
      for (int nn = 0; nn < kStr / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key0 : key1;
          const int c = 8 * nn + 2 * tc + (e & 1);
          const int qr = q0 + c;
          const bool live = key < T && qr < T && !(causal && key > qr);
          const float p = live ? expf(scale * s[nn][e] - Ls[c]) : 0.f;
          s[nn][e] = p;
          dp[nn][e] = p * (dp[nn][e] + lo[nn][e] - Ds[c]) * scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q, straight into the accumulators:
      // summing each tile from zero, as dq does, leaves dk/dv too few
      // registers for its loads and products in flight (16% slower)
#pragma unroll
      for (int kk = 0; kk < kStr / 8; ++kk) {
        const FragA pa = frag_acc(s[kk]);
        const FragA da = frag_acc(dp[kk]);
#pragma unroll
        for (int nn = 0; nn < kN; ++nn) {
          mma3(acc_v[nn], pa,
               load_b_perm<kRow>(Gs, 8 * kk, 8 * nn, gr, tc));
          mma3(acc_k[nn], da,
               load_b_perm<kRow>(Qs, 8 * kk, 8 * nn, gr, tc));
        }
      }
    }
    __syncthreads();                 // this stage is free for tile j + 2
  }
  store_acc<D>(dk + base, key0, T, acc_k, tc);
  store_acc<D>(dv + base, key0, T, acc_v, tc);
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One block per (bh, tile of `rows` rows).
bool bad_grid(int bh, int T, int rows, long long* blocks) {
  if (bh <= 0 || T <= 0) return true;
  *blocks = (long long)((T + rows - 1) / rows) * bh;
  return *blocks > 0x7fffffffLL;
}

template <int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int bh, int T, int causal,
                       float scale, cudaStream_t s) {
  long long blocks;
  if (bad_grid(bh, T, kRes, &blocks)) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes<D>();
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
  if (bad_grid(bh, T, kRes, &blocks)) return cudaErrorInvalidValue;
  const size_t smem = dq_smem_bytes<D>();
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
  if (bad_grid(bh, T, kRes, &blocks)) return cudaErrorInvalidValue;
  const size_t smem = dkv_smem_bytes<D>();
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
