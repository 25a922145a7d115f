// Segment reduce over (partition, key)-sorted rows for Hopper (sm_90a).
//
// Replaces the TPU kernel
// sparkucx_tpu/ops/pallas/segmented.py::_segreduce_blocked_kernel, in both
// its modes: wire_words=0 (sxt_segment_reduce, the receive-side combine of
// a multi-shard combine read) and wire_words>0 (sxt_segment_reduce_wire,
// the int8-dequant-fused reduce of an a2a.wire=int8 combine read).
// Per logical shard p, independently, over rows [P, cap, W_in] int32 sorted
// by (partition, key) with part [P, cap] int32 (sentinel num_parts on
// invalid rows, which sort last):
//   - a row starts a run iff it is valid and its (part, key_hi, key_lo)
//     differs from the row before it (row 0 compares against nothing);
//   - run j's output row j carries the key lanes and every lane after
//     2 + sum_words from the run's first row; its sum_words lanes are the
//     run's sums (uint32 ring sums, or float32 sums in row order);
//   - n_out[p] is the number of runs; rows at and past it are zero with
//     part num_parts.
// The fused mode takes rows in the int8 wire format, [key lo, key hi,
// packed int8 x ceil(ww/4), f32 scale], and writes full-width rows [key lo,
// key hi, ww float32 lanes]: each value is int8 times the row's scale, one
// rounded product (__fmul_rn, as wire_unpack_rows computes it), summed in
// float32 in row order or carried from the run's first row.
//
// Bound: bytes. The kernel must read every row's partition and the words
// of every valid row once, and write the n_out run rows; the zero tail
// (rows n_out..cap, part num_parts) adds its rows written. At 3.35 TB/s.
//
// The TPU kernel walks its grid in order and carries the open run across
// tiles in scratch memory. Blocks on Hopper run in parallel with nothing
// carried between them, so the design is one pass with a chained scan,
// then the tail:
//   1. reduce_tiles, one block per tile of T consecutive rows of a shard
//      (T from tile_rows_for: about 40 KB of rows in shared memory; 1,024
//      rows at width 6, 256 at the wire width 35). Tile ids come from an
//      atomic counter, so a tile's predecessors are already running.
//      - The tile's partitions are loaded first; only the rows up to its
//        last valid row are staged, as one contiguous span of words with
//        16-byte cp.async copies (a scalar head up to the first aligned
//        word and a scalar tail), all in flight at once. Sentinel rows'
//        payloads are never read.
//      - Run starts and run ends are flagged from shared memory and
//        ranked with one block scan (both counts packed in one word), so
//        run j's rows are [start_j, end_j) in the tile. Key words are
//        read from global memory once.
//      - A decoupled look-back (Merrill & Garland's single-pass prefix
//        scan) gives the tile's first output slot: each tile publishes
//        its run count, then its inclusive prefix, as one 64-bit status
//        word (flag in the high half) with a release store; warp 0 reads
//        up to 32 predecessors at once with acquire loads. Each shard is
//        its own chain. A tile where no run starts publishes its zero
//        count and never waits (a tile of sentinel rows returns once its
//        partitions are read), so the sentinel tail, most of a combine's
//        receive buffer, holds no block in the look-back; a tile with
//        runs raises n_out[p] to its inclusive prefix (atomicMax; n_out
//        starts zeroed).
//      - The block's k runs go to the contiguous output slots
//        [base, base + k): thread t writes words t, t + 256, ... of that
//        word range, coalesced (rows of 32 words or more: warp w writes
//        rows w, w + 8, ..., a lane per word). A sum word adds its run's
//        rows in row order from shared memory (fused mode: extracts its
//        byte from the staged packed word and scales it), a carried or
//        key word is the run's first row. So global memory sees each
//        packed word once.
//      - A run that starts in the tile and continues past it belongs to
//        this tile; the last warp finds its end 32 rows at a time
//        (ballot) and adds the continuation rows from global memory after
//        the tile's rows, one lane per output lane, in row order. Later
//        tiles skip its rows because they are not starts.
//   2. zero_tail: rows n_out[p]..cap of each shard zeroed and their
//      partitions set to num_parts, reading n_out on the device; 16-byte
//      stores after a scalar head, about 8 a thread over a grid sized to
//      the whole buffer (sxt_segment_reduce_tail alone, so it can be timed
//      on its own).
// The wrapper allocates the status words and the tile counter zeroed
// (torch.zeros); the kernel allocates nothing.
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers, the scratch it allocated and the current stream, and raises on
// a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 40960;     // staged rows per tile, at most
constexpr int kMaxTileRows = 1024;     // run and end counts fit 16 bits
constexpr int kMaxSmem = 232448;       // dynamic shared memory of a block
constexpr int kDefaultSmem = 49152;    // above it the launch must opt in
constexpr int kTailStores = 8;         // int4 stores a tail thread makes
constexpr int kPartLoads = kMaxTileRows / kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

int tile_rows_for(int width_in) {
  if (width_in <= 0) return 0;
  const int t = kStageBytes / (width_in * 4);
  if (t >= kMaxTileRows) return kMaxTileRows;
  if (t >= kThreads) return t / kThreads * kThreads;
  return t > 0 ? t : 1;
}

// staged words (room for the up-to-3-word alignment shift), then part,
// run starts and run ends, T ints each
__host__ __device__ long long stage_words(int tile_rows, int width_in) {
  return ((long long)tile_rows * width_in + 6) & ~3LL;
}

long long smem_bytes(int tile_rows, int width_in) {
  return (stage_words(tile_rows, width_in) + 3LL * tile_rows) * 4;
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Value lane j of a wire row: byte j % 4 of word 2 + j / 4, sign-extended,
// times the row's float32 scale (word 2 + qw).
__device__ __forceinline__ float dequant(const int* row, int j, int qw) {
  const int b = (row[2 + (j >> 2)] >> (8 * (j & 3))) & 0xFF;
  return __fmul_rn(static_cast<float>((b ^ 0x80) - 0x80),
                   __int_as_float(row[2 + qw]));
}

// Output lane c (>= 2) of `count` rows `stride` words apart, added in row
// order onto `acc` (the bits of the sum so far).
template <bool kWire>
__device__ __forceinline__ int add_rows(const int* row, int stride,
                                        long long count, int c,
                                        int float_acc, int qw, int acc) {
  if (kWire || float_acc) {
    float s = __int_as_float(acc);
    for (long long i = 0; i < count; ++i, row += stride) {
      if constexpr (kWire) {
        s += dequant(row, c - 2, qw);
      } else {
        s += __int_as_float(row[c]);
      }
    }
    return __float_as_int(s);
  }
  uint32_t s = static_cast<uint32_t>(acc);     // wraps mod 2^32
  for (long long i = 0; i < count; ++i, row += stride) {
    s += static_cast<uint32_t>(row[c]);
  }
  return static_cast<int>(s);
}

template <bool kWire>
__device__ __forceinline__ int carried(const int* first, int c, int qw) {
  if constexpr (kWire) {
    return __float_as_int(dequant(first, c - 2, qw));
  } else {
    return first[c];
  }
}

// kWire = false: rows and output share the width. kWire = true: input rows
// are int8 wire rows of width_in = 2 + qw + 1 words; the output is width =
// 2 + wire_words words with float32 sums over the dequantized lanes.
template <bool kWire>
__global__ void __launch_bounds__(kThreads)
reduce_tiles(const int* __restrict__ rows, const int* __restrict__ part,
             int* __restrict__ out_rows, int* __restrict__ out_part,
             int* __restrict__ n_out, unsigned long long* status,
             unsigned int* tile_counter, long long cap, int width_in,
             int width, int tile_rows, int ntiles, int num_parts,
             int sum_words, int float_acc, int qw) {
  extern __shared__ int4 smem_v[];
  int* s_stage = reinterpret_cast<int*>(smem_v);
  int* s_part = s_stage + stage_words(tile_rows, width_in);
  int* s_start = s_part + tile_rows;
  int* s_end = s_start + tile_rows;
  __shared__ int s_warp[kWarps];
  __shared__ int s_prev[3], s_next[3];       // part, key lo, key hi
  __shared__ int s_nstage, s_cont_next, s_base;
  __shared__ unsigned s_tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    s_tile = atomicAdd(tile_counter, 1u);
    s_nstage = 0;
  }
  __syncthreads();
  const int p = static_cast<int>(s_tile / ntiles);
  const int t = static_cast<int>(s_tile - (unsigned)p * ntiles);
  const long long r0 = (long long)t * tile_rows;
  const int n = static_cast<int>(min((long long)tile_rows, cap - r0));
  const int* g_rows = rows + ((long long)p * cap + r0) * width_in;
  const int* g_part = part + (long long)p * cap + r0;

  // partitions, and the extent of the rows worth staging; every load is
  // issued before the first store (one round trip, not one per row)
  int v[kPartLoads];
#pragma unroll
  for (int u = 0; u < kPartLoads; ++u) {
    const int l = tid + u * kThreads;
    v[u] = l < n ? g_part[l] : num_parts;
  }
  int edge[3] = {num_parts, 0, 0};           // the row before / after it
  const long long e = tid == 0 ? -1 : n;
  if ((tid == 0 && r0 > 0) || (tid == 32 && r0 + n < cap)) {
    edge[0] = g_part[e];
    edge[1] = g_rows[e * width_in];
    edge[2] = g_rows[e * width_in + 1];
  }
  int last = -1;
#pragma unroll
  for (int u = 0; u < kPartLoads; ++u) {
    const int l = tid + u * kThreads;
    if (l < n) {
      s_part[l] = v[u];
      if (v[u] < num_parts) last = l;
    }
  }
  last = __reduce_max_sync(kFull, last);
  if (lane == 0 && last >= 0) atomicMax(&s_nstage, last + 1);
  if (tid == 0 || tid == 32) {
    int* dst = tid == 0 ? s_prev : s_next;
    dst[0] = edge[0];
    dst[1] = edge[1];
    dst[2] = edge[2];
  }
  __syncthreads();
  if (s_nstage == 0) {                       // no valid row, no run
    if (tid == 0) {
      publish(status + (long long)p * ntiles + t,
              t == 0 ? kInclusive : kAggregate);
    }
    return;
  }

  // stage rows [0, n_stage) as one span: word i at s_stage[shift + i],
  // so global and shared 16-byte boundaries coincide
  const int len = s_nstage * width_in;
  const int shift = static_cast<int>(
      (reinterpret_cast<uintptr_t>(g_rows) >> 2) & 3);
  const int head = min((4 - shift) & 3, len);
  const int nvec = (len - head) >> 2;
  const int4* gv = reinterpret_cast<const int4*>(g_rows + head);
  const unsigned sv = static_cast<unsigned>(
      __cvta_generic_to_shared(s_stage + shift + head));
  for (int i = tid; i < nvec; i += kThreads) {   // all in flight at once
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     sv + 16u * i), "l"(gv + i) : "memory");
  }
  const int rest = head + (nvec << 2);
  if (tid < head) s_stage[shift + tid] = g_rows[tid];
  if (rest + tid < len) s_stage[shift + rest + tid] = g_rows[rest + tid];
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int* st = s_stage + shift;

  // row l (in [0, n]) continues the run of the row before it
  auto cont = [&](int l) -> bool {
    if (l == n) {
      return n > 0 && s_next[0] < num_parts && s_part[n - 1] == s_next[0] &&
             st[(n - 1) * width_in] == s_next[1] &&
             st[(n - 1) * width_in + 1] == s_next[2];
    }
    const int pl = s_part[l];
    if (pl >= num_parts) return false;
    if (l == 0) {
      return pl == s_prev[0] && st[0] == s_prev[1] && st[1] == s_prev[2];
    }
    return pl == s_part[l - 1] &&
           st[l * width_in] == st[(l - 1) * width_in] &&
           st[l * width_in + 1] == st[(l - 1) * width_in + 1];
  };

  // whether each row continues its predecessor's run, with consecutive
  // threads on consecutive rows (the key reads stay free of bank
  // conflicts), kept in s_start until the ranks overwrite it
  for (int l = tid; l < n; l += kThreads) s_start[l] = cont(l);
  if (tid == 0) s_cont_next = cont(n);
  __syncthreads();

  // starts and ends of this thread's rows, a block of rpt consecutive rows
  const int rpt = (tile_rows + kThreads - 1) / kThreads;
  const int l0 = tid * rpt;
  unsigned starts = 0, ends = 0;
  int counts = 0;                            // starts | ends << 16
  for (int i = 0; i < rpt && l0 + i < n; ++i) {
    const int l = l0 + i;
    const bool valid = s_part[l] < num_parts;
    const bool c_next = l + 1 < n ? s_start[l + 1] != 0 : s_cont_next != 0;
    if (valid && !s_start[l]) { starts |= 1u << i; counts += 1; }
    if (valid && !c_next) { ends |= 1u << i; counts += 1 << 16; }
  }
  const int foreign = s_start[0];

  // block scan of the packed counts: ranks of this thread's starts and ends
  int x = counts;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int excl = x - counts + (warp > 0 ? s_warp[warp - 1] : 0);
  const int total = s_warp[kWarps - 1];
  const int k = total & 0xFFFF;              // runs starting in the tile
  const int ne = total >> 16;                // runs ending in the tile
  int rs = excl & 0xFFFF, re = excl >> 16;
  for (int i = 0; i < rpt; ++i) {
    if (starts >> i & 1u) s_start[rs++] = l0 + i;
    if (ends >> i & 1u) s_end[re++] = l0 + i + 1;
  }

  // chained scan: this tile's first output slot within shard p
  if (warp == 0) {
    unsigned long long* chain = status + (long long)p * ntiles;
    int prefix = 0;
    if (t == 0) {
      if (lane == 0) publish(chain, kInclusive | (unsigned)k);
    } else if (k == 0) {                     // nothing to place: no wait
      if (lane == 0) publish(chain + t, kAggregate);
    } else {
      if (lane == 0) publish(chain + t, kAggregate | (unsigned)k);
      int top = t - 1;
      for (;;) {
        const int j = top - lane;
        unsigned long long s = kInclusive;   // before tile 0: prefix 0
        if (j >= 0) {
          do {
            s = observe(chain + j);
          } while ((s >> 32) == 0);
        }
        const unsigned incl = __ballot_sync(kFull, (s >> 32) == 2);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        int v = lane <= stop ? static_cast<int>(s & kFull) : 0;
        v = __reduce_add_sync(kFull, v);
        prefix += v;
        if (incl) break;
        top -= 32;
      }
      if (lane == 0) publish(chain + t, kInclusive | (unsigned)(prefix + k));
    }
    if (lane == 0) {
      s_base = prefix;
      if (k > 0) atomicMax(n_out + p, prefix + k);
    }
  }
  __syncthreads();

  const int base = s_base;
  // the tile's last run has no end inside it: it continues past the tile
  const bool open = k > 0 && k - 1 + foreign >= ne;
  int* dst = out_rows + ((long long)p * cap + base) * width;
  // word c of a run whose first row is `first` and whose rows number cnt
  // (-1: the open run, whose sum lanes the last warp writes below)
  auto emit = [&](int* w, int c, const int* first, int cnt) {
    if (c < 2) {
      *w = first[c];
    } else if (c >= 2 + sum_words) {
      *w = carried<kWire>(first, c, qw);
    } else if (cnt >= 0) {
      *w = add_rows<kWire>(first, width_in, cnt, c, float_acc, qw, 0);
    }
  };
  auto count = [&](int j) {
    return open && j == k - 1 ? -1 : s_end[j + foreign] - s_start[j];
  };
  if (width >= 32) {                         // a warp to a run's row
    for (int j = warp; j < k; j += kWarps) {
      const int* first = st + s_start[j] * width_in;
      const int cnt = count(j);
      int* drow = dst + (long long)j * width;
      for (int c = lane; c < width; c += 32) emit(drow + c, c, first, cnt);
    }
  } else {                                   // the block over all words
    const int dj = kThreads / width, dc = kThreads % width;
    int j = tid / width, c = tid % width;
    for (int idx = tid; idx < k * width; idx += kThreads) {
      emit(dst + idx, c, st + s_start[j] * width_in, count(j));
      j += dj;
      c += dc;
      if (c >= width) { c -= width; ++j; }
    }
  }
  for (int r = tid; r < k; r += kThreads) {
    out_part[(long long)p * cap + base + r] = s_part[s_start[r]];
  }

  if (open && warp == kWarps - 1) {
    const int s0 = s_start[k - 1];
    const int* first = st + s0 * width_in;
    const int p0 = s_part[s0], k0 = first[0], k1 = first[1];
    const long long lim = cap - r0;
    long long e = n;                         // the run's end, tile-relative
    for (;;) {
      const long long r = e + lane;
      bool same = false;
      if (r < lim) {
        const int* g = g_rows + r * width_in;
        same = g_part[r] == p0 && g[0] == k0 && g[1] == k1;
      }
      const unsigned m = __ballot_sync(kFull, same);
      if (m != kFull) {
        e += __ffs(~m) - 1;
        break;
      }
      e += 32;
    }
    int* drow = dst + (long long)(k - 1) * width;
    for (int cc = 2 + lane; cc < 2 + sum_words; cc += 32) {
      const int in_tile = add_rows<kWire>(first, width_in, n - s0, cc,
                                          float_acc, qw, 0);
      drow[cc] = add_rows<kWire>(g_rows + (long long)n * width_in, width_in,
                                 e - n, cc, float_acc, qw, in_tile);
    }
  }
}

// Words [lo, hi) of base set to value: a scalar head up to the first
// 16-byte boundary, int4 stores, a scalar tail; grid-stride.
__device__ __forceinline__ void fill_words(int* base, long long lo,
                                           long long hi, int value,
                                           long long gtid, long long gsize) {
  if (lo >= hi) return;
  int* a = base + lo;
  const long long len = hi - lo;
  const long long mis = (reinterpret_cast<uintptr_t>(a) >> 2) & 3;
  const long long head = min((4 - mis) & 3, len);
  const long long nvec = (len - head) >> 2;
  int4* v = reinterpret_cast<int4*>(a + head);
  const int4 fill = make_int4(value, value, value, value);
  for (long long i = gtid; i < nvec; i += gsize) __stcs(v + i, fill);
  const long long rest = head + (nvec << 2);
  if (gtid < head) a[gtid] = value;
  if (rest + gtid < len) a[rest + gtid] = value;
}

__global__ void __launch_bounds__(kThreads)
zero_tail(int* __restrict__ out_rows, int* __restrict__ out_part,
          const int* __restrict__ n_out, long long cap, int width,
          int num_parts) {
  const long long p = blockIdx.y;
  const long long n = n_out[p];
  const long long gtid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gsize = (long long)gridDim.x * kThreads;
  fill_words(out_rows + p * cap * width, n * width, cap * width, 0, gtid,
             gsize);
  fill_words(out_part + p * cap, n, cap, num_parts, gtid, gsize);
}

int launch_tail(int* out_rows, int* out_part, const int* n_out,
                int num_shards, int cap, int width, int num_parts,
                cudaStream_t s) {
  const long long words = (long long)cap * width;
  constexpr long long kWordsPerBlock = 4LL * kTailStores * kThreads;
  const dim3 grid(
      static_cast<unsigned>((words + kWordsPerBlock - 1) / kWordsPerBlock),
      num_shards);
  zero_tail<<<grid, kThreads, 0, s>>>(out_rows, out_part, n_out, cap, width,
                                      num_parts);
  return static_cast<int>(cudaGetLastError());
}

// reduce_tiles, then the tail, on one stream; width_in == width unless
// kWire. scratch: num_shards * ceil(cap / T) + 1 zeroed 64-bit words (the
// status words, then the tile counter); n_out zeroed.
template <bool kWire>
int launch(const int* rows, const int* part, int* out_rows, int* out_part,
           int* n_out, unsigned long long* scratch, int num_shards, int cap,
           int width_in, int width, int num_parts, int sum_words,
           int float_acc, int qw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile_rows = tile_rows_for(width_in);
  const long long smem = smem_bytes(tile_rows, width_in);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (cap + tile_rows - 1) / tile_rows;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reduce_tiles<kWire>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unsigned* counter = reinterpret_cast<unsigned*>(
      scratch + (long long)num_shards * ntiles);
  reduce_tiles<kWire><<<(unsigned)num_shards * ntiles, kThreads, smem, s>>>(
      rows, part, out_rows, out_part, n_out, scratch, counter, cap, width_in,
      width, tile_rows, ntiles, num_parts, sum_words, float_acc, qw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tail(out_rows, out_part, n_out, num_shards, cap, width,
                     num_parts, s);
}

}  // namespace

// Rows per tile for rows of width_in words (the scratch is num_shards *
// ceil(cap / T) + 1 64-bit words); 0 when one row does not fit a block's
// shared memory.
extern "C" int sxt_segment_reduce_tile_rows(int width_in) {
  const int t = tile_rows_for(width_in);
  return t > 0 && smem_bytes(t, width_in) <= kMaxSmem ? t : 0;
}

extern "C" int sxt_segment_reduce(const int* rows, const int* part,
                                  int* out_rows, int* out_part, int* n_out,
                                  unsigned long long* scratch,
                                  int num_shards, int cap, int width,
                                  int num_parts, int sum_words,
                                  int float_acc, void* stream) {
  if (num_shards <= 0 || cap <= 0 || width < 2 || sum_words < 0 ||
      sum_words > width - 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(rows, part, out_rows, out_part, n_out, scratch,
                       num_shards, cap, width, width, num_parts, sum_words,
                       float_acc, 0, stream);
}

// The int8-dequant-fused mode (a2a.wire=int8 combine reads): rows are
// [P, cap, 2 + ceil(wire_words / 4) + 1] wire rows, the output
// [P, cap, 2 + wire_words] full-width rows with float32 sums.
extern "C" int sxt_segment_reduce_wire(const int* rows, const int* part,
                                       int* out_rows, int* out_part,
                                       int* n_out,
                                       unsigned long long* scratch,
                                       int num_shards, int cap,
                                       int wire_words, int num_parts,
                                       int sum_words, void* stream) {
  if (num_shards <= 0 || cap <= 0 || wire_words <= 0 || sum_words < 0 ||
      sum_words > wire_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int qw = (wire_words + 3) / 4;
  return launch<true>(rows, part, out_rows, out_part, n_out, scratch,
                      num_shards, cap, 2 + qw + 1, 2 + wire_words,
                      num_parts, sum_words, 1, qw, stream);
}

// The zero tail alone: rows n_out[p]..cap of out_rows [P, cap, width] set
// to 0 and of out_part [P, cap] to num_parts.
extern "C" int sxt_segment_reduce_tail(int* out_rows, int* out_part,
                                       const int* n_out, int num_shards,
                                       int cap, int width, int num_parts,
                                       void* stream) {
  if (num_shards <= 0 || cap <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tail(out_rows, out_part, n_out, num_shards, cap, width,
                     num_parts, static_cast<cudaStream_t>(stream));
}
