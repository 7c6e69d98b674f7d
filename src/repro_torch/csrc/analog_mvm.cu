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
// Training form: an optional quant-noise mask `keep` (uint8, (M, T, N), T
// the ADC conversions per output: ceil(K / tile_rows) with per-tile ADC and
// K > tile_rows, else 1) selects, per ADC'd value, the quantized or the
// full-precision partial, as src/repro/core/engine.py::tile_matmul_quant
// does with a quant-noise key (engine.py:219-246):
//
//   per tile:   q_t = (float)(T)(keep[m,t,n] ? quant(p_t) : p_t)
//   one tile:   out = (keep[m,0,n] ? quant(y) : y) * out_scale
//
// A null mask runs the serving arithmetic above unchanged.
//
// The staging, weight loads, fp32 tile sums and quantizer live in
// analog_mvm_core.cuh, shared with decode_fused.cu. Ragged M, N and K edges
// are masked in the kernel. The kernel allocates nothing and runs on the
// caller's stream; the launcher returns cudaGetLastError().

#include "analog_mvm_core.cuh"

namespace {

using amvm::kCols;
using amvm::kRows;
using amvm::kThreads;
using amvm::Traits;

template <typename T>
__global__ void __launch_bounds__(kThreads)
analog_mvm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int M, int K, int N,
                  const float* r_dac_p, const float* r_adc_p,
                  const float* out_scale_p, float r_dac_h, float r_adc_h,
                  float out_scale_h, int b_dac, int b_adc, int tile_rows,
                  int per_tile_adc, int apply_dac, int vec_ok,
                  const uint8_t* __restrict__ keep) {
  __shared__ amvm::TileSmem sm;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;

  // ranges come from device scalars when given (no host sync), else host
  float r_a, step_a;
  amvm::quant_range(r_adc_p ? *r_adc_p : r_adc_h, b_adc, r_a, step_a);
  float r_d = 0.f, step_d = 1.f;
  if (apply_dac) amvm::quant_range(r_dac_p ? *r_dac_p : r_dac_h, b_dac, r_d, step_d);
  const float out_scale = out_scale_p ? *out_scale_p : out_scale_h;

  const bool multi = per_tile_adc && K > tile_rows;
  const int span = multi ? tile_rows : K;  // rows summed per ADC conversion

  // the (row, column) this thread owns in the tile epilogue
  const int orow = tid / kCols;
  const int ocol = tid % kCols;
  const int m = m0 + orow;
  const int n = n0 + ocol;
  const bool inside = m < M && n < N;
  // this output's row of the mask: T entries, N apart
  const int n_tiles = (K + span - 1) / span;
  const uint8_t* krow =
      keep && inside ? keep + (static_cast<size_t>(m) * n_tiles) * N + n : nullptr;
  float yacc = 0.f;

  for (int t0 = 0; t0 < K; t0 += span) {
    const int t1 = min(t0 + span, K);
    const float part = amvm::tile_partial<T>(sm, x, w, M, K, N, m0, n0, t0, t1,
                                             apply_dac, r_d, step_d, vec_ok);
    if (multi) {
      const bool q_it = !krow || krow[static_cast<size_t>(t0 / span) * N];
      const float q = Traits<T>::round_trip(q_it ? amvm::quant(part, r_a, step_a) : part);
      yacc = (t0 == 0) ? q : __fadd_rn(yacc, q);
    } else {
      yacc = part;
    }
  }

  const bool q_out = !multi && (!krow || krow[0]);
  float out = q_out ? amvm::quant(yacc, r_a, step_a) : yacc;
  out = __fmul_rn(out, out_scale);
  if (inside) y[static_cast<size_t>(m) * N + n] = Traits<T>::from_f(out);
}

template <typename T>
int launch(const void* x, const void* w, void* y, int M, int K, int N,
           const void* r_dac_p, const void* r_adc_p, const void* out_scale_p,
           float r_dac_h, float r_adc_h, float out_scale_h, int b_dac,
           int b_adc, int tile_rows, int per_tile_adc, int apply_dac,
           int vec_ok, const void* keep, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  analog_mvm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      M, K, N, static_cast<const float*>(r_dac_p),
      static_cast<const float*>(r_adc_p), static_cast<const float*>(out_scale_p),
      r_dac_h, r_adc_h, out_scale_h, b_dac, b_adc, tile_rows, per_tile_adc,
      apply_dac, vec_ok, static_cast<const uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. A null range pointer takes the host
// value beside it; a null keep is the serving form (no quant-noise mask).
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int analog_mvm_launch(const void* x, const void* w, void* y, int M,
                                 int K, int N, int dtype, const void* r_dac_p,
                                 const void* r_adc_p, const void* out_scale_p,
                                 float r_dac_h, float r_adc_h,
                                 float out_scale_h, int b_dac, int b_adc,
                                 int tile_rows, int per_tile_adc,
                                 int apply_dac, int vec_ok, const void* keep,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, y, M, K, N, r_dac_p, r_adc_p, out_scale_p,
                         r_dac_h, r_adc_h, out_scale_h, b_dac, b_adc,
                         tile_rows, per_tile_adc, apply_dac, vec_ok, keep, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, M, K, N, r_dac_p, r_adc_p,
                                 out_scale_p, r_dac_h, r_adc_h, out_scale_h,
                                 b_dac, b_adc, tile_rows, per_tile_adc,
                                 apply_dac, vec_ok, keep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* analog_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
