// Segment reduce over (partition, key)-sorted rows for Hopper (sm_90a).
//
// Replaces the TPU kernel
// sparkucx_tpu/ops/pallas/segmented.py::_segreduce_blocked_kernel, in both
// its modes: wire_words=0 (sxt_segment_reduce, the receive-side combine of
// a multi-shard combine read) and wire_words>0 (sxt_segment_reduce_wire,
// the int8-dequant-fused reduce of an a2a.wire=int8 combine read, below).
// Per logical shard p, independently, over rows [P, cap, W] int32 sorted
// by (partition, key) with part [P, cap] int32 (sentinel num_parts on
// invalid rows, which sort last):
//   - a row starts a run iff it is valid and its (part, key_hi, key_lo)
//     differs from the row before it (row 0 compares against nothing);
//   - run j's output row j carries the key lanes and every lane after
//     2 + sum_words from the run's first row; its sum_words lanes are the
//     run's sums (uint32 ring sums, or float32 sums in row order);
//   - n_out[p] is the number of runs; rows at and past it are zero with
//     part num_parts.
//
// The TPU kernel walks its grid in order and carries the open run across
// tiles in scratch memory, with one-hot matmuls for the per-tile sums.
// Blocks on Hopper run in parallel with nothing carried between them, so
// the design is three passes on the caller's stream:
//   1. count_starts: each thread flags one row; __syncthreads_count gives
//      the block's run-start count;
//   2. scan_counts: one block per shard scans the block counts (warp
//      shuffles) into each block's first output slot, and n_out;
//   3. emit_runs: the thread that owns a run's first row ranks it in its
//      block (ballot + popc), walks to the run's end summing, and writes
//      slot block_base + rank; threads whose row index is >= n_out write
//      the zero tail. A run of any length is right; on the combine path
//      map-side combine leaves runs of at most P rows, so walks are short.
//
// Bound: bytes. The least traffic is reading rows and part once,
// P*cap*(W+1)*4 bytes, and writing the n_out run rows, P*n_out*W*4 bytes,
// at 3.35 TB/s (the zero tail adds P*(cap-n_out)*(W+1)*4 written bytes).
// Pass 3 re-reads the key and part words pass 1 read (from L2 at these
// sizes), and a run's owner reads its rows one thread at a time, so the
// design trades coalescing for simplicity.
//
// The fused mode (sxt_segment_reduce_wire) takes rows in the int8 wire
// format, [key lo, key hi, packed int8 x ceil(ww/4), f32 scale], and writes
// full-width rows [key lo, key hi, ww float32 lanes]. Passes 1-2 read only
// the key lanes and the partition, which sit where they sit in raw rows,
// so they run unchanged on the narrower input stride. In pass 3 the run's
// owner dequantizes each lane (int8 times the row's scale: one rounded
// product), sums the first sum_words lanes in float32 in row order and
// carries the others from the run's first row. Bound: bytes again; the
// input is read at its wire width (2 + ceil(ww/4) + 1 lanes) and the
// output written at full width, so the least traffic is
// P*cap*(W_in+1)*4 read + n_out*(2+ww)*4 written.
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers, the scratch it allocated and the current stream, and raises on
// a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // rows per block, passes 1 and 3
constexpr int kScanThreads = 1024;  // pass 2
constexpr int kWarps = kScanThreads / 32;

__device__ __forceinline__ bool same_run(const int* __restrict__ rows,
                                         const int* __restrict__ part,
                                         long long a, long long b,
                                         int width) {
  return part[a] == part[b] && rows[a * width] == rows[b * width] &&
         rows[a * width + 1] == rows[b * width + 1];
}

__device__ __forceinline__ bool run_start(const int* __restrict__ rows,
                                          const int* __restrict__ part,
                                          long long i, int width,
                                          int num_parts) {
  if (part[i] >= num_parts) return false;   // sentinel rows never count
  return i == 0 || !same_run(rows, part, i, i - 1, width);
}

__global__ void __launch_bounds__(kThreads)
count_starts(const int* __restrict__ rows, const int* __restrict__ part,
             int* __restrict__ block_counts, long long cap, int width,
             int num_parts, int nblk) {
  const long long p = blockIdx.y;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int* r = rows + p * cap * width;
  const int* pt = part + p * cap;
  const int flag = i < cap && run_start(r, pt, i, width, num_parts);
  const int n = __syncthreads_count(flag);
  if (threadIdx.x == 0) block_counts[p * nblk + blockIdx.x] = n;
}

__global__ void __launch_bounds__(kScanThreads)
scan_counts(const int* __restrict__ block_counts, int* __restrict__ block_base,
            int* __restrict__ n_out, int nblk) {
  __shared__ int warp_sums[kWarps];
  const long long p = blockIdx.x;
  const int* in = block_counts + p * nblk;
  int* out = block_base + p * nblk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < nblk; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < nblk ? in[i] : 0;
    int x = v;                                 // inclusive scan in the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {                           // scan of the warp totals
      int w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < nblk) out[i] = carry + excl;
    carry += warp_sums[kWarps - 1];
    __syncthreads();                           // warp_sums is reused
  }
  if (threadIdx.x == 0) n_out[p] = carry;
}

// Value lane j of a wire row: byte j % 4 of word 2 + j / 4, sign-extended,
// times the row's float32 scale (lane 2 + qw) — one rounded product, as
// wire_unpack_rows computes it (__fmul_rn keeps a later add from fusing
// into it).
__device__ __forceinline__ float dequant(const int* __restrict__ row, int j,
                                         int qw) {
  const int b = (row[2 + (j >> 2)] >> (8 * (j & 3))) & 0xFF;
  return __fmul_rn(static_cast<float>((b ^ 0x80) - 0x80),
                   __int_as_float(row[2 + qw]));
}

// kWire = false: rows and output share the width (wire_words unused).
// kWire = true: input rows are int8 wire rows of width_in = 2 + qw + 1
// lanes; the output is full width = 2 + wire_words, float32 sums over
// the dequantized lanes.
template <bool kWire>
__global__ void __launch_bounds__(kThreads)
emit_runs(const int* __restrict__ rows, const int* __restrict__ part,
          int* __restrict__ out_rows, int* __restrict__ out_part,
          const int* __restrict__ block_base, const int* __restrict__ n_out,
          long long cap, int width_in, int width, int num_parts,
          int sum_words, int float_acc, int wire_words, int nblk) {
  __shared__ int warp_counts[kThreads / 32];
  const long long p = blockIdx.y;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int* r = rows + p * cap * width_in;
  const int* pt = part + p * cap;
  int* orow = out_rows + p * cap * width;
  int* opart = out_part + p * cap;
  const bool start = i < cap && run_start(r, pt, i, width_in, num_parts);

  // rank of this run start among the block's starts
  const unsigned mask = __ballot_sync(0xffffffffu, start);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(mask);
  __syncthreads();
  int rank = __popc(mask & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_counts[w];

  if (i < cap && i >= n_out[p]) {              // the zero tail
    for (int c = 0; c < width; ++c) orow[i * width + c] = 0;
    opart[i] = num_parts;
  }
  if (!start) return;

  long long end = i + 1;
  while (end < cap && same_run(r, pt, end, i, width_in)) ++end;
  const long long slot = block_base[p * nblk + blockIdx.x] + rank;
  const int* first = r + i * width_in;
  int* dst = orow + slot * width;
  dst[0] = first[0];
  dst[1] = first[1];
  if constexpr (kWire) {
    const int qw = (wire_words + 3) / 4;
    for (int c = 0; c < sum_words; ++c) {
      float s = 0.0f;
      for (long long j = i; j < end; ++j) s += dequant(r + j * width_in, c, qw);
      dst[2 + c] = __float_as_int(s);
    }
    for (int c = sum_words; c < wire_words; ++c) {
      dst[2 + c] = __float_as_int(dequant(first, c, qw));
    }
  } else {
    for (int c = 2; c < 2 + sum_words; ++c) {
      if (float_acc) {
        float s = 0.0f;
        for (long long j = i; j < end; ++j) {
          s += __int_as_float(r[j * width + c]);
        }
        dst[c] = __float_as_int(s);
      } else {
        uint32_t s = 0;                        // wraps mod 2^32
        for (long long j = i; j < end; ++j) s += (uint32_t)r[j * width + c];
        dst[c] = (int)s;
      }
    }
    for (int c = 2 + sum_words; c < width; ++c) dst[c] = first[c];
  }
  opart[slot] = pt[i];
}

// The three passes on one stream; width_in == width unless kWire.
template <bool kWire>
int launch(const int* rows, const int* part, int* out_rows, int* out_part,
           int* n_out, int* block_counts, int* block_base, int num_shards,
           int cap, int width_in, int width, int nblk, int num_parts,
           int sum_words, int float_acc, int wire_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, num_shards);
  count_starts<<<grid, kThreads, 0, s>>>(rows, part, block_counts, cap,
                                         width_in, num_parts, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_counts<<<num_shards, kScanThreads, 0, s>>>(block_counts, block_base,
                                                  n_out, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_runs<kWire><<<grid, kThreads, 0, s>>>(
      rows, part, out_rows, out_part, block_base, n_out, cap, width_in,
      width, num_parts, sum_words, float_acc, wire_words, nblk);
  return static_cast<int>(cudaGetLastError());
}

bool bad_grid(int num_shards, int cap, int nblk) {
  return num_shards <= 0 || cap <= 0 || (long long)nblk * kThreads < cap ||
         (long long)(nblk - 1) * kThreads >= cap;
}

}  // namespace

extern "C" int sxt_segment_reduce(const int* rows, const int* part,
                                  int* out_rows, int* out_part, int* n_out,
                                  int* block_counts, int* block_base,
                                  int num_shards, int cap, int width,
                                  int nblk, int num_parts, int sum_words,
                                  int float_acc, void* stream) {
  if (bad_grid(num_shards, cap, nblk) || width < 2 || sum_words < 0 ||
      sum_words > width - 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(rows, part, out_rows, out_part, n_out, block_counts,
                       block_base, num_shards, cap, width, width, nblk,
                       num_parts, sum_words, float_acc, 0, stream);
}

// The int8-dequant-fused mode (a2a.wire=int8 combine reads): rows are
// [P, cap, 2 + ceil(wire_words / 4) + 1] wire rows, the output
// [P, cap, 2 + wire_words] full-width rows with float32 sums.
extern "C" int sxt_segment_reduce_wire(const int* rows, const int* part,
                                       int* out_rows, int* out_part,
                                       int* n_out, int* block_counts,
                                       int* block_base, int num_shards,
                                       int cap, int wire_words, int nblk,
                                       int num_parts, int sum_words,
                                       void* stream) {
  if (bad_grid(num_shards, cap, nblk) || wire_words <= 0 || sum_words < 0 ||
      sum_words > wire_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width_in = 2 + (wire_words + 3) / 4 + 1;
  return launch<true>(rows, part, out_rows, out_part, n_out, block_counts,
                      block_base, num_shards, cap, width_in, 2 + wire_words,
                      nblk, num_parts, sum_words, 1, wire_words, stream);
}
