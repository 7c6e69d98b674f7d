// Programmed analog-CiM MVM for Hopper (sm_90a): DAC -> crossbar-tiled MVM
// -> per-tile ADC -> digital accumulation -> GDC epilogue.
//
// Replaces the TPU kernel src/repro/kernels/analog_mvm.py::_kernel (launched
// by analog_mvm_fwd, pallas_call at analog_mvm.py:147) and computes what the
// serving path's src/repro/core/engine.py::tile_matmul_quant computes:
//
//   for each crossbar tile t of `tile_rows` rows of K (the last one ragged):
//       p_t = sum_k x_q[m,k] * w[k,n]                 (fp32, K rows of the tile)
//       q_t = round(clip(p_t, -r, r) / step) * step   (ADC; r = |r_adc| + 1e-9,
//                                                      step = r / (2^(b-1) - 1),
//                                                      round half to even)
//       q_t = (float)(T)q_t                           (stored at the activation
//                                                      dtype, engine.py:242)
//   y = ((q_0 + q_1) + q_2) + ...                     (tile-serial, fp32)
//   out = (T)(y * out_scale)
//
// With per_tile_adc == 0, or K <= tile_rows, the whole fp32 sum is converted
// once and there is no intermediate dtype rounding (engine.py:219-222); that
// branch is kept separate so bf16 is not rounded twice. A ragged last tile
// is quantized over its real rows, which equals the TPU kernel's zero pad.
// The optional DAC (apply_dac) fake-quantizes x at b_dac bits as it is
// staged, like the TPU kernel's fused input quantization.
//
// Bound: decode runs this at M = number of slots (8), so each call is a GEMV
// that reads every weight once and does 2 flops per weight byte (bf16): it is
// bound by weight bytes over HBM bandwidth (K*N*2 bytes / 3.35 TB/s), far
// below the tensor-core line. The design spends its effort on the weight
// stream: every weight is read exactly once per block row of M (one block
// row for M <= 8) with 16-byte vector loads, neighbouring lanes on
// neighbouring columns; x is staged once per block in shared memory and
// reused by all 32 columns; the K loop is unrolled so several loads are in
// flight per thread. Blocks own 32 output columns, so lm_head's N = 32000
// runs on 1000 blocks; N = 256 gives only 8 (split-K, wgmma and TMA are
// later work). Products and sums stay in fp32 FMA on the CUDA cores: no TF32
// and no tensor-core rounding, so fp32 inputs keep full precision and bf16
// products are exact.
//
// Ragged M, N and K edges are masked in the kernel. The kernel allocates
// nothing and runs on the caller's stream; the launcher returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // rows of x (M) per block, kept as accumulators
constexpr int kCols = 32;     // output columns (N) per block
constexpr int kChunk = 1024;  // rows of K staged in shared memory at a time

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static float to_f(float v) { return v; }
  __device__ static float round_trip(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round_trip(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Hard symmetric fake-quant; the _rn intrinsics keep the compiler from
// contracting the final multiply into a following add.
__device__ __forceinline__ float quant(float v, float r, float step) {
  v = fminf(fmaxf(v, -r), r);
  return __fmul_rn(rintf(__fdiv_rn(v, step)), step);
}

template <typename T>
__device__ __forceinline__ void load_w(const T* __restrict__ w, int k, int n_cols,
                                       int ncol, int vec_ok,
                                       float (&out)[Traits<T>::kVec]) {
  constexpr int V = Traits<T>::kVec;
  const T* row = w + static_cast<size_t>(k) * n_cols;
  if (vec_ok) {
    // n_cols % V == 0, so a vector is either wholly inside or wholly past N
    if (ncol < n_cols) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + ncol));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = Traits<T>::to_f(e[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = 0.f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int n = ncol + v;
      out[v] = n < n_cols ? Traits<T>::to_f(row[n]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
analog_mvm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int M, int K, int N,
                  const float* r_dac_p, const float* r_adc_p,
                  const float* out_scale_p, float r_dac_h, float r_adc_h,
                  float out_scale_h, int b_dac, int b_adc, int tile_rows,
                  int per_tile_adc, int apply_dac, int vec_ok) {
  constexpr int V = Traits<T>::kVec;
  constexpr int CL = kCols / V;       // lanes across the block's columns
  constexpr int KL = 32 / CL;         // lanes across K within a warp
  constexpr int KSTEP = kWarps * KL;  // K rows the block covers per step

  __shared__ float xs[kRows][kChunk];
  __shared__ float red[kWarps][kRows][kCols];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cl = lane % CL;
  const int kl = lane / CL;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int ncol = n0 + cl * V;
  const int kidx = warp * KL + kl;

  // ranges come from device scalars when given (no host sync), else host
  const float r_a = __fadd_rn(fabsf(r_adc_p ? *r_adc_p : r_adc_h), 1e-9f);
  const float step_a = __fdiv_rn(r_a, static_cast<float>((1 << (b_adc - 1)) - 1));
  float r_d = 0.f, step_d = 1.f;
  if (apply_dac) {
    r_d = __fadd_rn(fabsf(r_dac_p ? *r_dac_p : r_dac_h), 1e-9f);
    step_d = __fdiv_rn(r_d, static_cast<float>((1 << (b_dac - 1)) - 1));
  }
  const float out_scale = out_scale_p ? *out_scale_p : out_scale_h;

  const bool multi = per_tile_adc && K > tile_rows;
  const int span = multi ? tile_rows : K;  // rows summed per ADC conversion

  // the (row, column) this thread owns in the tile epilogue
  const int orow = tid / kCols;
  const int ocol = tid % kCols;
  float yacc = 0.f;

  for (int t0 = 0; t0 < K; t0 += span) {
    const int t1 = min(t0 + span, K);
    float acc[kRows][V];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

    for (int c0 = t0; c0 < t1; c0 += kChunk) {
      const int clen = min(c0 + kChunk, t1) - c0;
      __syncthreads();  // the previous chunk (and tile epilogue) is consumed
      for (int i = tid; i < kRows * clen; i += kThreads) {
        const int r = i / clen;
        const int kk = i - r * clen;
        const int m = m0 + r;
        float v = 0.f;
        if (m < M) {
          v = Traits<T>::to_f(x[static_cast<size_t>(m) * K + c0 + kk]);
          if (apply_dac) v = quant(v, r_d, step_d);
        }
        xs[r][kk] = v;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = kidx; kk < clen; kk += KSTEP) {
        float wv[V];
        load_w<T>(w, c0 + kk, N, ncol, vec_ok, wv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r][kk];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
        }
      }
    }

    // sum the KL lanes sharing a column (fixed butterfly order), then the
    // warps (fixed order), giving the tile's fp32 partial
#pragma unroll
    for (int off = CL; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r][v] += __shfl_xor_sync(0xffffffffu, acc[r][v], off);
    if (kl == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) red[warp][r][cl * V + v] = acc[r][v];
    }
    __syncthreads();
    float part = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) part = __fadd_rn(part, red[wi][orow][ocol]);
    if (multi) {
      const float q = Traits<T>::round_trip(quant(part, r_a, step_a));
      yacc = (t0 == 0) ? q : __fadd_rn(yacc, q);
    } else {
      yacc = part;
    }
  }

  const int m = m0 + orow;
  const int n = n0 + ocol;
  float out = multi ? yacc : quant(yacc, r_a, step_a);
  out = __fmul_rn(out, out_scale);
  if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = Traits<T>::from_f(out);
}

template <typename T>
int launch(const void* x, const void* w, void* y, int M, int K, int N,
           const void* r_dac_p, const void* r_adc_p, const void* out_scale_p,
           float r_dac_h, float r_adc_h, float out_scale_h, int b_dac,
           int b_adc, int tile_rows, int per_tile_adc, int apply_dac,
           int vec_ok, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  analog_mvm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      M, K, N, static_cast<const float*>(r_dac_p),
      static_cast<const float*>(r_adc_p), static_cast<const float*>(out_scale_p),
      r_dac_h, r_adc_h, out_scale_h, b_dac, b_adc, tile_rows, per_tile_adc,
      apply_dac, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. A null range pointer takes the host
// value beside it. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int analog_mvm_launch(const void* x, const void* w, void* y, int M,
                                 int K, int N, int dtype, const void* r_dac_p,
                                 const void* r_adc_p, const void* out_scale_p,
                                 float r_dac_h, float r_adc_h,
                                 float out_scale_h, int b_dac, int b_adc,
                                 int tile_rows, int per_tile_adc,
                                 int apply_dac, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, y, M, K, N, r_dac_p, r_adc_p, out_scale_p,
                         r_dac_h, r_adc_h, out_scale_h, b_dac, b_adc,
                         tile_rows, per_tile_adc, apply_dac, vec_ok, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, M, K, N, r_dac_p, r_adc_p,
                                 out_scale_p, r_dac_h, r_adc_h, out_scale_h,
                                 b_dac, b_adc, tile_rows, per_tile_adc,
                                 apply_dac, vec_ok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* analog_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
