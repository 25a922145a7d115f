// Merge of two (partition, key)-sorted row buffers for Hopper (sm_90a).
//
// Replaces the TPU kernel sparkucx_tpu/ops/pallas/segmented.py::
// _merge_path_kernel (reached through _merge_pallas from merge_rows and
// merge_reduce_rows: every fold step of a waved ordered or combine read
// with the device sink). Per logical shard p, independently, over
// A rows [ca, W] int32 with part [ca] and B rows [cb, W] with part [cb],
// each sorted by (part signed, key_hi signed, key_lo unsigned), output
// row d of [0, out_cap) is the d-th row of the merge, ties taking A:
//   rank(a_k) = k + |{j : b_j < a_k}|,  rank(b_j) = j + |{k : a_k <= b_j}|.
// Partition ids travel with their rows. Rows at and past out_cap are not
// written (the fold keeps only its accumulator's capacity).
//
// Design. Grid (output tiles of kTile rows, P). One thread per block
// binary-searches the merge-path split of the tile's first diagonal d0,
// the smallest i in [max(0, d0-cb), min(d0, ca)] with b[d0-i-1] < a[i],
// and leaves it in shared memory. The block loads the keys of the two
// windows that hold every row of its tile (at most kTile rows of A from
// the split and kTile of B) into shared memory; each thread searches its
// own diagonal inside the windows (8 steps over shared memory) and records
// its row's source. Last, the block copies the tile's rows word by word:
// consecutive threads write consecutive output words and read from the
// two contiguous input ranges.
//
// The TPU kernel pads both inputs with a tile of sentinel rows so that its
// window loads stay in bounds, and gathers the tile with one-hot matmuls;
// both exist for Mosaic. Here indices are guarded instead (a pad would copy
// both buffers on every fold step) and rows move by plain loads and
// stores. Offsets are 64-bit: P*cap*W reaches 3e8 words at the main path's
// shapes.
//
// Bound: bytes. Each output row comes from exactly one input row, so a
// shard must read out_cap*(W+1)*4 bytes and write as many, at 3.35 TB/s
// (rows of A and B past the cut need not be read). The copy reads only
// the rows it writes; the split searches and the key windows re-read
// about 3/W of the rows' bytes (mostly from L2).
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;   // output rows per block = threads per block

__device__ __forceinline__ bool key_lt(int pa, int ha, unsigned la, int pb,
                                       int hb, unsigned lb) {
  if (pa != pb) return pa < pb;
  if (ha != hb) return ha < hb;
  return la < lb;
}

// b[j] < a[i], both read from device memory
__device__ __forceinline__ bool b_lt_a(const int* __restrict__ a,
                                       const int* __restrict__ ap,
                                       const int* __restrict__ b,
                                       const int* __restrict__ bp,
                                       long long i, long long j, int width) {
  return key_lt(bp[j], b[j * width + 1], (unsigned)b[j * width], ap[i],
                a[i * width + 1], (unsigned)a[i * width]);
}

__global__ void __launch_bounds__(kTile)
merge_path(const int* __restrict__ a_rows, const int* __restrict__ a_part,
           const int* __restrict__ b_rows, const int* __restrict__ b_part,
           int* __restrict__ out_rows, int* __restrict__ out_part,
           long long ca, long long cb, long long out_cap, int width) {
  __shared__ long long s_split;
  __shared__ int sa_part[kTile], sa_hi[kTile], sb_part[kTile], sb_hi[kTile];
  __shared__ unsigned sa_lo[kTile], sb_lo[kTile];
  // source of each output row: >= 0 a row of A, < 0 row -(s+1) of B
  __shared__ long long s_src[kTile];

  const long long p = blockIdx.y;
  const long long d0 = (long long)blockIdx.x * kTile;
  const int t = threadIdx.x;
  const int* a = a_rows + p * ca * width;
  const int* ap = a_part + p * ca;
  const int* b = b_rows + p * cb * width;
  const int* bp = b_part + p * cb;

  if (t == 0) {
    long long lo = d0 > cb ? d0 - cb : 0;
    long long hi = d0 < ca ? d0 : ca;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (b_lt_a(a, ap, b, bp, mid, d0 - mid - 1, width)) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    s_split = lo;
  }
  __syncthreads();
  const long long ia0 = s_split;
  const long long ib0 = d0 - ia0;
  // window lengths; i < na (j < nb) below is i < ca - ia0 (j < cb - ib0)
  // because every local index is below kTile
  const int na = (int)(ca - ia0 < kTile ? ca - ia0 : kTile);
  const int nb = (int)(cb - ib0 < kTile ? cb - ib0 : kTile);
  if (t < na) {
    const long long i = ia0 + t;
    sa_part[t] = ap[i];
    sa_hi[t] = a[i * width + 1];
    sa_lo[t] = (unsigned)a[i * width];
  }
  if (t < nb) {
    const long long j = ib0 + t;
    sb_part[t] = bp[j];
    sb_hi[t] = b[j * width + 1];
    sb_lo[t] = (unsigned)b[j * width];
  }
  __syncthreads();

  const int n_tile = (int)(out_cap - d0 < kTile ? out_cap - d0 : kTile);
  if (t < n_tile) {
    int lo = t > nb ? t - nb : 0;
    int hi = t < na ? t : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int j = t - mid - 1;
      if (key_lt(sb_part[j], sb_hi[j], sb_lo[j], sa_part[mid], sa_hi[mid],
                 sa_lo[mid])) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const int i = lo;
    const int j = t - lo;
    const bool take_a =
        i < na && (j >= nb || !key_lt(sb_part[j], sb_hi[j], sb_lo[j],
                                      sa_part[i], sa_hi[i], sa_lo[i]));
    s_src[t] = take_a ? ia0 + i : -(ib0 + j) - 1;
    out_part[p * out_cap + d0 + t] = take_a ? sa_part[i] : sb_part[j];
  }
  __syncthreads();

  int* out = out_rows + (p * out_cap + d0) * width;
  const int words = n_tile * width;
  for (int w = t; w < words; w += kTile) {
    const int r = w / width;
    const int c = w - r * width;
    const long long s = s_src[r];
    out[w] = s >= 0 ? a[s * width + c] : b[(-s - 1) * width + c];
  }
}

}  // namespace

extern "C" int sxt_merge_path(const int* a_rows, const int* a_part,
                              const int* b_rows, const int* b_part,
                              int* out_rows, int* out_part, int num_shards,
                              int ca, int cb, int out_cap, int width,
                              void* stream) {
  if (num_shards <= 0 || num_shards > 65535 || ca < 0 || cb < 0 ||
      out_cap < 0 || (long long)out_cap > (long long)ca + cb || width < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_cap == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((out_cap + kTile - 1) / kTile, num_shards);
  merge_path<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      a_rows, a_part, b_rows, b_part, out_rows, out_part, ca, cb, out_cap,
      width);
  return static_cast<int>(cudaGetLastError());
}
