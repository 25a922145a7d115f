// Merge of two (partition, key)-sorted row buffers for Hopper (sm_90a).
//
// Replaces the TPU kernel sparkucx_tpu/ops/pallas/segmented.py::
// _merge_path_kernel (reached through _merge_pallas from merge_rows and
// merge_reduce_rows: every fold step of a waved ordered or combine read
// with the device sink). Per logical shard p, independently, over
// A rows [ca, W] int32 with part [ca] and B rows [cb, W] with part [cb],
// each sorted by (part signed, key_hi signed, key_lo unsigned), output
// row d of [0, out_cap) is the d-th row of the merge, ties taking A: the
// split of diagonal d is the smallest i in [max(0, d-cb), min(d, ca)]
// with b[d-i-1] < a[i]. Partition ids travel with their rows. Rows at
// and past out_cap are not written (the fold keeps only its accumulator's
// capacity).
//
// Bound: bytes. Each output row comes from exactly one input row, so a
// shard must read out_cap*(W+1)*4 bytes and write as many, at 3.35 TB/s
// (rows of A and B past the cut need not be read).
//
// Design. Two launches on one stream, through two C entries
// (sxt_merge_splits, then sxt_merge_path, so that the wrapper's output
// allocations overlap the first).
//  1. merge_splits: one thread per tile boundary d_k = min(k*T, out_cap),
//     k = 0..n_tiles, binary-searches the split of d_k in device memory
//     and writes it to the caller's scratch [P, n_tiles + 1]. All of the
//     searches are in flight at once: one round of ~log2(ca) dependent
//     loads for the whole merge.
//  2. merge_tiles: block (k, p) owns output rows [d_k, d_k+1). Its A span
//     [ia_k, ia_k+1) and B span [d_k - ia_k, d_k+1 - ia_k+1) together are
//     exactly the tile's rows, so the block stages both spans into shared
//     memory with 16-byte cp.async copies (several in flight per thread)
//     and reads every input byte once. Each staged span keeps its global
//     16-byte phase (cp.async needs both ends aligned; shard bases, spans
//     and a tensor's storage offset are aligned to 4 bytes only); the
//     words before the first and after the last 16-byte boundary of a
//     span go by scalar loads, so nothing outside [base, base + bytes) of
//     an input is read. Each thread then searches its row's diagonal in
//     the staged keys (words 0 and 1 of the staged rows), records the
//     staged offset of its source row and writes its partition id
//     (coalesced). Last, the tile's n*W output words, which are
//     contiguous, go out as 16-byte stores with a scalar head and tail,
//     assembled from the staged rows through the source-offset table;
//     the row of a word comes from a multiply-high by a reciprocal of W
//     once per 16-byte store, never a division. T is picked from W so
//     that the staging is about 50 KB (T = 512 at W = 25, 4 blocks an
//     SM): larger tiles leave fewer boundaries to search, and at 4
//     blocks an SM 200 KB of staging is in flight.
//  Rows wider than kMaxStagedWidth words take merge_rows_wide instead:
//  T = 1, so the pre-pass gives every row's source, and a block copies
//  one row device memory to device memory (16-byte loads and stores when
//  source and destination share their phase).
//
// The TPU kernel pads both inputs with a tile of sentinel rows so that its
// window loads stay in bounds, and gathers the tile with one-hot matmuls;
// both exist for Mosaic. Here indices are guarded instead (a pad would copy
// both buffers on every fold step), and a span is clamped to its side's
// rows even when the inputs break the sort contract. The copy moves the
// input words as they are (the fold's invalid rows are not zero). Offsets
// are 64-bit: P*cap*W reaches 3e8 words at the main path's shapes.
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers, the splits scratch and the current stream, and raises on a
// non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageWords = 12800;    // staged row words per tile (50 KB)
constexpr int kMaxTile = 1024;        // rows per tile
constexpr int kMaxStagedWidth = kStageWords / 16;  // wider: merge_rows_wide
constexpr int kSplitThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;  // more needs the opt-in

int tile_rows_for(int width) {
  if (width > kMaxStagedWidth) return 1;
  const int t = kStageWords / width;
  return t < kMaxTile ? t : kMaxTile;
}

// staged row words of a tile: its rows, two 16-byte phases, a round-up;
// the partition ids and the source offsets of T rows follow them
int stage_words_for(int tile, int width) {
  return (tile * width + 12 + 3) & ~3;
}

__device__ __forceinline__ bool key_lt(int pa, int ha, unsigned la, int pb,
                                       int hb, unsigned lb) {
  if (pa != pb) return pa < pb;
  if (ha != hb) return ha < hb;
  return la < lb;
}

__device__ __forceinline__ int phase(const int* p) {   // word in 16 bytes
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// A span of na rows and a B span of nb rows with na + nb = n, whatever
// the splits say (they break only when the inputs are not sorted): the
// clamp keeps both spans inside their side's rows.
__device__ __forceinline__ int span_a(long long ia0, long long ia1,
                                      long long ib0, long long ca,
                                      long long cb, int n) {
  long long na = ia1 - ia0;
  const long long lo = n - (cb - ib0) > 0 ? n - (cb - ib0) : 0;
  const long long hi = ca - ia0 < n ? ca - ia0 : n;
  na = na < lo ? lo : na;
  return static_cast<int>(na > hi ? hi : na);
}

__global__ void __launch_bounds__(kSplitThreads)
merge_splits(const int* __restrict__ a_rows, const int* __restrict__ a_part,
             const int* __restrict__ b_rows, const int* __restrict__ b_part,
             int* __restrict__ splits, long long ca, long long cb,
             long long out_cap, int width, int tile, int n_bounds) {
  const int k = blockIdx.x * kSplitThreads + threadIdx.x;
  if (k >= n_bounds) return;
  const long long p = blockIdx.y;
  const int* a = a_rows + p * ca * width;
  const int* ap = a_part + p * ca;
  const int* b = b_rows + p * cb * width;
  const int* bp = b_part + p * cb;
  const long long d0 = (long long)k * tile;
  const long long d = d0 < out_cap ? d0 : out_cap;
  long long lo = d > cb ? d - cb : 0;
  long long hi = d < ca ? d : ca;
  while (lo < hi) {
    const long long i = (lo + hi) >> 1;
    const long long j = d - i - 1;
    if (key_lt(__ldg(bp + j), __ldg(b + j * width + 1),
               (unsigned)__ldg(b + j * width), __ldg(ap + i),
               __ldg(a + i * width + 1), (unsigned)__ldg(a + i * width))) {
      hi = i;
    } else {
      lo = i + 1;
    }
  }
  splits[p * n_bounds + k] = static_cast<int>(lo);
}

// words [0, n) of src into dst, which has src's 16-byte phase: 16-byte
// cp.async for the aligned body, scalar loads for the head and tail
__device__ __forceinline__ void stage_span(int* dst, const int* src, int n,
                                           int t) {
  const int head = min((4 - phase(src)) & 3, n);
  const int nvec = (n - head) >> 2;
  const int4* gv = reinterpret_cast<const int4*>(src + head);
  const unsigned sv =
      static_cast<unsigned>(__cvta_generic_to_shared(dst + head));
  for (int v = t; v < nvec; v += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     sv + 16u * v), "l"(gv + v) : "memory");
  }
  const int rest = head + (nvec << 2);
  if (t < head) dst[t] = src[t];
  if (rest + t < n) dst[rest + t] = src[rest + t];
}

__global__ void __launch_bounds__(kThreads)
merge_tiles(const int* __restrict__ a_rows, const int* __restrict__ a_part,
            const int* __restrict__ b_rows, const int* __restrict__ b_part,
            int* __restrict__ out_rows, int* __restrict__ out_part,
            const int* __restrict__ splits, long long ca, long long cb,
            long long out_cap, int width, int tile, int stage_words,
            unsigned div_w) {
  extern __shared__ int4 smem_v[];
  int* smem = reinterpret_cast<int*>(smem_v);
  const int t = threadIdx.x;
  const int k = blockIdx.x;
  const long long p = blockIdx.y;
  const long long d0 = (long long)k * tile;
  const int n = static_cast<int>(out_cap - d0 < tile ? out_cap - d0 : tile);
  const int* sp = splits + p * (gridDim.x + 1) + k;
  const long long ia0 = sp[0];
  const long long ib0 = d0 - ia0;
  const int na = span_a(ia0, sp[1], ib0, ca, cb, n);
  const int nb = n - na;

  const int* ga = a_rows + (p * ca + ia0) * width;
  const int* gb = b_rows + (p * cb + ib0) * width;
  const int* gap = a_part + p * ca + ia0;
  const int* gbp = b_part + p * cb + ib0;
  // staged A row i at smem[sa + i*W], B row j at smem[sb + j*W]
  const int sa = phase(ga);
  const int sb = ((sa + na * width + 3) & ~3) + phase(gb);
  int* s_part = smem + stage_words;    // A's ids, then B's
  int* s_src = s_part + tile;          // staged offset of output row r
  stage_span(smem + sa, ga, na * width, t);
  stage_span(smem + sb, gb, nb * width, t);
  for (int r = t; r < na; r += kThreads) s_part[r] = gap[r];
  for (int r = t; r < nb; r += kThreads) s_part[na + r] = gbp[r];
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // b[j] < a[i] on the staged keys
  auto b_lt_a = [&](int j, int i) -> bool {
    const int* rb = smem + sb + j * width;
    const int* ra = smem + sa + i * width;
    return key_lt(s_part[na + j], rb[1], (unsigned)rb[0], s_part[i], ra[1],
                  (unsigned)ra[0]);
  };
  int* op = out_part + p * out_cap + d0;
  for (int r = t; r < n; r += kThreads) {
    int lo = r > nb ? r - nb : 0;
    int hi = r < na ? r : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (b_lt_a(r - mid - 1, mid)) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const int j = r - lo;
    const bool take_a = lo < na && (j >= nb || !b_lt_a(j, lo));
    s_src[r] = take_a ? sa + lo * width : sb + j * width;
    op[r] = s_part[take_a ? lo : na + j];
  }
  __syncthreads();

  // output word w of the tile is word w % W of row w / W
  int* out = out_rows + (p * out_cap + d0) * width;
  const int words = n * width;
  const int head = min((4 - phase(out)) & 3, words);
  const int nvec = (words - head) >> 2;
  auto word = [&](int w) -> int {
    const int r = static_cast<int>(__umulhi(static_cast<unsigned>(w),
                                            div_w));
    return smem[s_src[r] + w - r * width];
  };
  int4* ov = reinterpret_cast<int4*>(out + head);
  for (int v = t; v < nvec; v += kThreads) {
    const int w = head + (v << 2);
    int r = static_cast<int>(__umulhi(static_cast<unsigned>(w), div_w));
    int c = w - r * width;
    const int* row = smem + s_src[r];
    int x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q > 0 && c == width) {
        c = 0;
        row = smem + s_src[++r];
      }
      x[q] = row[c++];
    }
    ov[v] = make_int4(x[0], x[1], x[2], x[3]);
  }
  const int rest = head + (nvec << 2);
  if (t < head) out[t] = word(t);
  if (rest + t < words) out[rest + t] = word(rest + t);
}

// T = 1 for wide rows: the splits give each output row's source; a block
// copies it whole
__global__ void __launch_bounds__(kThreads)
merge_rows_wide(const int* __restrict__ a_rows,
                const int* __restrict__ a_part,
                const int* __restrict__ b_rows,
                const int* __restrict__ b_part, int* __restrict__ out_rows,
                int* __restrict__ out_part, const int* __restrict__ splits,
                long long ca, long long cb, long long out_cap, int width) {
  const int t = threadIdx.x;
  const long long d = blockIdx.x;
  const long long p = blockIdx.y;
  const int* sp = splits + p * (out_cap + 1) + d;
  const long long ia0 = sp[0];
  const long long ib0 = d - ia0;
  const bool take_a = span_a(ia0, sp[1], ib0, ca, cb, 1) == 1;
  const int* src = take_a ? a_rows + (p * ca + ia0) * width
                          : b_rows + (p * cb + ib0) * width;
  int* dst = out_rows + (p * out_cap + d) * width;
  if (t == 0) {
    out_part[p * out_cap + d] =
        take_a ? a_part[p * ca + ia0] : b_part[p * cb + ib0];
  }
  int head = width;                    // all scalar unless phases agree
  int nvec = 0;
  if (phase(src) == phase(dst)) {
    head = min((4 - phase(src)) & 3, width);
    nvec = (width - head) >> 2;
  }
  const int4* sv = reinterpret_cast<const int4*>(src + head);
  int4* dv = reinterpret_cast<int4*>(dst + head);
  // (unrolled, these loops spill)
#pragma unroll 1
  for (int v = t; v < nvec; v += kThreads) dv[v] = sv[v];
#pragma unroll 1
  for (int w = t; w < head; w += kThreads) dst[w] = src[w];
#pragma unroll 1
  for (int w = head + (nvec << 2) + t; w < width; w += kThreads) {
    dst[w] = src[w];
  }
}

bool bad_args(int num_shards, int ca, int cb, int out_cap, int width) {
  return num_shards <= 0 || num_shards > 65535 || ca < 0 || cb < 0 ||
         out_cap < 0 || (long long)out_cap > (long long)ca + cb || width < 2;
}

int n_tiles_for(int out_cap, int tile) {
  return static_cast<int>(((long long)out_cap + tile - 1) / tile);
}

}  // namespace

// Rows per output tile for rows of `width` words (1: one row per block,
// no staging). The splits scratch holds num_shards * (ceil(out_cap / T)
// + 1) int32 words.
extern "C" int sxt_merge_tile_rows(int width) {
  return width >= 2 ? tile_rows_for(width) : 0;
}

// The pre-pass: the split of every tile boundary into `splits`. The
// wrapper launches it first, so that its output allocations overlap it.
extern "C" int sxt_merge_splits(const int* a_rows, const int* a_part,
                                const int* b_rows, const int* b_part,
                                int* splits, int num_shards, int ca, int cb,
                                int out_cap, int width, void* stream) {
  if (bad_args(num_shards, ca, cb, out_cap, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_cap == 0) return static_cast<int>(cudaSuccess);
  const int tile = tile_rows_for(width);
  const int n_bounds = n_tiles_for(out_cap, tile) + 1;
  const dim3 grid((n_bounds + kSplitThreads - 1) / kSplitThreads,
                  num_shards);
  merge_splits<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a_rows, a_part, b_rows, b_part, splits, ca, cb, out_cap, width, tile,
      n_bounds);
  return static_cast<int>(cudaGetLastError());
}

// The merge proper, on the splits sxt_merge_splits wrote (same arguments,
// same stream).
extern "C" int sxt_merge_path(const int* a_rows, const int* a_part,
                              const int* b_rows, const int* b_part,
                              int* out_rows, int* out_part,
                              const int* splits, int num_shards, int ca,
                              int cb, int out_cap, int width, void* stream) {
  if (bad_args(num_shards, ca, cb, out_cap, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_cap == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = tile_rows_for(width);
  const dim3 grid(n_tiles_for(out_cap, tile), num_shards);
  if (tile == 1) {
    merge_rows_wide<<<grid, kThreads, 0, s>>>(a_rows, a_part, b_rows, b_part,
                                              out_rows, out_part, splits, ca,
                                              cb, out_cap, width);
    return static_cast<int>(cudaGetLastError());
  }
  const int stage_words = stage_words_for(tile, width);
  const int smem = (stage_words + 2 * tile) * 4;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // multiply-high by this gives w / width exactly for w * width < 2^32
  const unsigned div_w = 0xFFFFFFFFu / static_cast<unsigned>(width) + 1u;
  merge_tiles<<<grid, kThreads, smem, s>>>(
      a_rows, a_part, b_rows, b_part, out_rows, out_part, splits, ca, cb,
      out_cap, width, tile, stage_words, div_w);
  return static_cast<int>(cudaGetLastError());
}
