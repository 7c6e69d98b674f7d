// The RNG bridge's normal draw on the card (sm_90a): jax.random.normal's
// bits, bit for bit, for the program phase, drift, refresh and per-step
// read-noise resampling of a full-width chip.
//
// Element i of a draw under key (k1, k2) is sqrt(2) * erf_inv(u), u the
// uniform on (-1, 1) made from the 23 high bits of b1 ^ b2, (b1, b2) =
// threefry2x32((k1, k2), (i >> 32, i & 0xffffffff)): JAX's partitionable
// threefry. erf_inv is XLA's f32 Giles polynomial over XLA-CPU's own
// log1p (a Cephes rational below sqrt(2) - 1, Eigen's plog above), with a
// fused multiply-add exactly where XLA-CPU's compiled code fuses one and
// every other rounding explicit (_rn intrinsics, so nvcc contracts
// nothing), and IEEE sqrt and division. The plain version
// (src/repro_torch/prng.py::normal) runs the same operations in PyTorch
// with the FMA made exact through f64; the two agree bit for bit, on the
// CPU and on the card.
//
// Not a port of a TPU kernel: the reference draws with jax.random's XLA
// ops. Bound: 4 bytes written per draw and ~300 integer and float
// operations; at 3.35 TB/s the bytes allow ~0.8 M draws per microsecond,
// the ALUs far fewer, so operations bound it. A thread per element,
// nothing staged.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// XLA-CPU's f32 log (Eigen's plog_float) of x > 0
__device__ __forceinline__ float plog(float x) {
  const float xc = fmaxf(x, 1.17549435e-38f);
  const int xb = __float_as_int(xc);
  const float m = __int_as_float((xb & 0x7FFFFF) | 0x3F000000);
  float e = __fadd_rn(static_cast<float>((xb >> 23) - 127), 1.0f);
  const bool small = m < 0.707106769f;
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float y = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float x2 = __fmul_rn(y, y);
  const float x3 = __fmul_rn(x2, y);
  const float p0 = fmaf(fmaf(y, 7.0376836292e-2f, -1.1514610310e-1f), y, 1.1676998740e-1f);
  const float p1 = fmaf(fmaf(y, -1.2420140846e-1f, 1.4249322787e-1f), y, -1.6668057665e-1f);
  const float p2 = fmaf(fmaf(y, 2.0000714765e-1f, -2.4999993993e-1f), y, 3.3333331174e-1f);
  float p = fmaf(p0, x3, p1);
  p = fmaf(p, x3, p2);
  p = fmaf(p, x3, __fmul_rn(e, -2.12194440e-4f));
  float r = fmaf(x2, -0.5f, y);
  r = fmaf(e, 0.693359375f, __fadd_rn(r, p));
  if (x == __int_as_float(0x7f800000)) return x;
  if (x == 0.f) return __int_as_float(0xff800000);
  return r;
}

// XLA-CPU's f32 log1p
__device__ __forceinline__ float log1p_xla(float x) {
  const float x2 = __fmul_rn(x, x);
  const float zero = __fmul_rn(x, 0.0f);
  float num = __fadd_rn(zero, 4.5270000862445199635215e-5f);
  num = fmaf(num, x, 4.9854102823193375972212e-1f);
  num = fmaf(num, x, 6.5787325942061044846969e0f);
  num = fmaf(num, x, 2.9911919328553073277375e1f);
  num = fmaf(num, x, 6.0949667980987787057556e1f);
  num = fmaf(num, x, 5.7112963590585538103336e1f);
  num = fmaf(num, x, 2.0039553499201281259648e1f);
  float den = __fadd_rn(zero, 1.0f);
  den = fmaf(den, x, 1.5062909083469192043167e1f);
  den = fmaf(den, x, 8.3047565967967209469434e1f);
  den = fmaf(den, x, 2.2176239823732856465394e2f);
  den = fmaf(den, x, 3.0909872225312059774938e2f);
  den = fmaf(den, x, 2.1642788614495947685003e2f);
  den = fmaf(den, x, 6.0118660497603843919306e1f);
  const float small = __fadd_rn(
      x, __fadd_rn(__fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den)), __fmul_rn(x2, -0.5f)));
  return fabsf(x) < 0.41421356237309504880f ? small : plog(__fadd_rn(x, 1.0f));
}

// XLA's f32 erf_inv
__device__ __forceinline__ float erf_inv_xla(float x) {
  const float w = -log1p_xla(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float z = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = fmaf(p, z, lt ? 3.43273939e-07f : 0.000100950558f);
  p = fmaf(p, z, lt ? -3.5233877e-06f : 0.00134934322f);
  p = fmaf(p, z, lt ? -4.39150654e-06f : -0.00367342844f);
  p = fmaf(p, z, lt ? 0.00021858087f : 0.00573950773f);
  p = fmaf(p, z, lt ? -0.00125372503f : -0.0076224613f);
  p = fmaf(p, z, lt ? -0.00417768164f : 0.00943887047f);
  p = fmaf(p, z, lt ? 0.246640727f : 1.00167406f);
  p = fmaf(p, z, lt ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

// scaled = 1: sqrt(2) * erf_inv(u), jax.random.normal; 0: erf_inv(u) alone.
// out[i] is the draw's element offset + (i / row_len) * row_stride +
// i % row_len: a slice of a larger draw (the program phase draws a large
// member's rows chunk by chunk; a rank of a sharded chip draws its columns,
// row_len of every row_stride counters)
__global__ void normal_kernel(uint32_t k1, uint32_t k2, float* __restrict__ out, int64_t offset,
                              int64_t n, int scaled, int64_t row_len, int64_t row_stride) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // the draw's flat counter
    const uint64_t c = static_cast<uint64_t>(offset + (i / row_len) * row_stride + i % row_len);
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry(k1, k2, x0, x1);
    const uint32_t bits = x0 ^ x1;
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    const float lo = -0.99999994f;  // nextafter(-1, 0)
    const float u = fmaxf(lo, fmaf(f, 2.0f, lo));
    const float e = erf_inv_xla(u);
    out[i] = scaled ? __fmul_rn(e, 1.41421354f) : e;
  }
}

}  // namespace

// n draws, rows of row_len elements each row_stride counters apart from
// counter offset on (row_len == row_stride: elements offset to offset + n - 1
// of the key's draw). Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int prng_normal_strided(unsigned int k1, unsigned int k2, void* out, long long offset,
                                   long long n, int scaled, long long row_len,
                                   long long row_stride, void* stream) {
  if (n < 0 || offset < 0 || row_len < 1 || row_stride < row_len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  normal_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      k1, k2, static_cast<float*>(out), offset, n, scaled, row_len, row_stride);
  return static_cast<int>(cudaGetLastError());
}

// n draws, elements offset to offset + n - 1 of the key's draw.
extern "C" int prng_normal(unsigned int k1, unsigned int k2, void* out, long long offset,
                           long long n, int scaled, void* stream) {
  return prng_normal_strided(k1, k2, out, offset, n, scaled, n > 0 ? n : 1, n > 0 ? n : 1,
                             stream);
}

extern "C" const char* prng_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
