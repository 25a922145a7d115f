// Per-row int8 quantization with stochastic rounding for Hopper (sm_90a).
//
// Replaces the TPU kernel sparkucx_tpu/ops/pallas/quant.py::_quant_kernel
// (the quantize half of the a2a.wire=int8 tier). For each row i of
// x [N, W] float32, with caller-supplied uniforms u [N, W] in [0, 1):
//   amax     = max_j |x[i, j]|
//   scale[i] = amax > 0 ? amax * float32(1/127) : 1
//   s        = x[i, j] / scale[i];  lo = floor(s);  frac = s - lo
//   q[i, j]  = clip(lo + (u[i, j] < frac), -127, 127)   as int8
// The uniforms come from the caller, as the TPU kernel takes them, so the
// two packages give the same bytes when fed the same u.
//
// Bit-exactness rests on IEEE arithmetic: a true division x / scale
// (never __fdividef, a reciprocal of scale or fast math), floorf, and the
// clip before the int8 store (x / scale can round to just above 127, and
// lo + 1 can reach 128). The scale is amax times the float32 reciprocal
// of 127, not amax / 127: the JAX source divides, but XLA compiles a
// division by a constant into that multiplication, so these are the bytes
// the reference produces (a true division differs in the last bit for a
// few percent of rows). Every row is quantized, pad rows included: an
// all-zero row gets scale 1.0.
//
// Design: one warp per row. Pass 1 strides the row (lane j reads columns
// j, j + 32, ...: neighbouring lanes on neighbouring addresses) and
// reduces |x| with __shfl_xor_sync, so every lane holds amax; pass 2
// re-reads x (from L1/L2: a row is at most a few KB) with u and writes q;
// lane 0 writes the scale.
//
// Bound: bytes. The least traffic is reading x and u once (8 bytes per
// element) and writing q (1 byte per element) and the scale (4 bytes per
// row), at 3.35 TB/s; the arithmetic is a handful of operations per
// element. The int8 stores are one byte per lane (32 bytes per warp
// instruction): packing four values per store is later work.
//
// Plain C interface (no PyTorch headers): the wrapper passes device
// pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr float kRecip127 = 1.0f / 127.0f;   // correctly rounded float32

__global__ void __launch_bounds__(kThreads)
quantize_rows(const float* __restrict__ x, const float* __restrict__ u,
              int8_t* __restrict__ q, float* __restrict__ scale, int n,
              int width) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;                 // whole warps leave together
  const float* xr = x + row * width;
  const float* ur = u + row * width;
  int8_t* qr = q + row * width;

  float amax = 0.0f;
  for (int j = lane; j < width; j += 32) amax = fmaxf(amax, fabsf(xr[j]));
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float s = amax > 0.0f ? amax * kRecip127 : 1.0f;

  for (int j = lane; j < width; j += 32) {
    const float scaled = xr[j] / s;
    const float lo = floorf(scaled);
    const float frac = scaled - lo;
    float v = lo + (ur[j] < frac ? 1.0f : 0.0f);
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    qr[j] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (lane == 0) scale[row] = s;
}

}  // namespace

extern "C" int sxt_quantize(const float* x, const float* u, int8_t* q,
                            float* scale, int n, int width, void* stream) {
  if (n <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = ((long long)n + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_rows<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, u, q, scale, n, width);
  return static_cast<int>(cudaGetLastError());
}
