// Programmed analog-CiM MVM for Hopper (sm_90a), fp32: the register-tiled
// CUDA-core design ("tiled") that kernels/analog_mvm.py::select_design picks
// for every fp32 launch -- the paper's CNNs (served and trained) and the LM's
// fp32 steps -- with the DAC, the per-tile ADC, the GDC epilogue and the
// training form's quant-noise keep mask.
//
// Replaces the TPU kernel src/repro/kernels/analog_mvm.py::_kernel (launched
// by analog_mvm_fwd, pallas_call at analog_mvm.py:147) for fp32 operands,
// and computes what analog_mvm.cu computes (its header has the function),
// src/repro/core/engine.py::tile_matmul_quant:
//
//   for each crossbar tile t of `span` rows of K (the last one ragged):
//       p_t = fmaf chain over k ascending in the tile, from zero, of
//             x_q[m,k] * w[k,n]                        (one thread, fp32)
//       q_t = keep[m,t,n] ? quant(p_t) : p_t           (ADC; no mask: quant)
//   y   = ((q_0 + q_1) + q_2) + ...                    (tile-serial, fp32)
//   out = y * out_scale
//
// and, with one span (per_tile_adc off, or K <= tile_rows), out =
// (keep[m,0,n] ? quant(p_0) : p_0) * out_scale. x_q is x, or with the DAC
// x fake-quantized at b_dac bits as it is staged. The quantizer is
// analog_mvm_core.cuh's (amvm::quant, amvm::quant_range), the same
// instruction sequence as the other designs.
//
// Why a new design: the CNN shapes are tall and narrow (AnalogNet-KWS at 256
// images: M = 32,000, K = 954, N = 106 three times; VWW's stem M = 160,000,
// K = 27, N = 24), so one launch is 2 M K N fp32 operations on the CUDA
// cores (TF32 would move ADC codes): bound by operations at 67 TFLOP/s. The
// CUDA-core gemv design (analog_mvm.cu) reads every weight again per 8 rows
// of M, ends every crossbar tile with a shuffle and shared-memory reduction
// and spends most of a 32-column strip on N = 2-24. This one is a
// register-tiled SGEMM: a block of 256 threads owns a BM x BN output tile,
// each thread a TM x TN micro-tile of fp32 accumulators; x and w tiles of
// kBK = 32 rows of K stream through a double buffer in shared memory by
// 4-byte cp.async with zero fill (chunk c + 1 is in flight while chunk c is
// multiplied; a chunk's FMAs stop at the crossbar tile's last row), x
// transposed so each thread reads its TM rows as 16-byte vectors. One block
// an SM, up to 255 registers a thread: the blocked sum below holds two
// registers an output, and at two blocks an SM (128 registers) the 8 x 4
// tile spilled. With the DAC each thread quantizes the x values it copied,
// in place, once they land. Every weight is read once per BM rows of M; a
// thread does TM x TN FMAs per TM / 4 + TN shared-memory reads (its columns
// are TX apart, lane-consecutive, so the epilogue's stores and mask reads
// are coalesced). The loads are 4-byte and masked, so no alignment is asked
// of K or N (9, 27, 954; 106, 12, 2).
//
// Tile shape (kernels/analog_mvm.py::tiled_plan): BN from N (16, 32, 64 or
// 128, so N = 2-12 does not waste a 64-column tile), BM from M (TM = 8, 4 or
// 2 rows a thread: the tallest that still puts a block on every SM). Row
// tiles are on grid.x. One block walks all of K, so a small launch (the
// always-on stream: one image, M = 125 at KWS's conv2, 8 blocks) is bound
// by one block's walk over K's chunks (a chunk's 32 dependent shared-memory
// reads and FMAs at 8 warps an SM: ~1.4 us a chunk, 0.045 ms at K = 954).
//
// Per-element order: each output's tile partial is, for each kBK-row chunk
// of the crossbar tile in order (chunks start at the tile's first row), one
// thread's fmaf chain over the chunk's k ascending from zero, added to the
// running fp32 sum (__fadd_rn) -- a blocked sum, whose rounding error
// grows with 32 + K / 32 terms rather than K. Rows past M, columns past N
// and rows of K past the crossbar tile's end stage as zeros, and an exact
// zero term leaves an fp32 sum's bits unchanged (a sum from +0 is never
// -0). So a row's bits depend on neither M, the row tile it lands in, nor
// the tile shape: an always-on single-image call and the same image inside
// a 256-image sweep give the same logits, bit for bit. The tile-serial sum
// of several crossbar tiles is carried in y itself (each thread re-reads
// only what it wrote), so it costs no registers.
//
// The kernel allocates nothing and runs on the caller's stream; the launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "analog_mvm_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // rows of K per staged chunk
constexpr int kPad = 4;  // floats of padding per shared row (keeps 16-byte rows)

// 4-byte async copy global -> shared; a false predicate writes zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// NV consecutive floats of shared memory (16- or 8-byte aligned by the
// layout) into registers
template <int NV>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int v = 0; v < NV; v += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + v);
      out[v] = t.x;
      out[v + 1] = t.y;
      out[v + 2] = t.z;
      out[v + 3] = t.w;
    }
  } else {
    static_assert(NV == 2, "2, 4 or 8 rows a thread");
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  }
}

// BM x BN output tile, TM x TN per thread: TX = BN / TN threads across N,
// TY = 256 / TX across M. Thread (tx, ty) owns rows ty * TM + i and columns
// tx + TX * j (lane-consecutive: the epilogue's stores and mask reads are
// coalesced). Shared memory (dynamic, smem_bytes<BM, BN>): two buffers of
// x transposed (kBK x (BM + kPad)) and of w (kBK x BN).
//
// BANK: the expert-bank form (grid.z = experts): expert e = blockIdx.z
// reads x[e] (M, K), w[e] (K, N), out_scale_p[e] and keep[e] (M, T, N) and
// writes y[e] (M, N), each at its own offset, with the 2-D kernel's
// instructions per element (an expert's slice is bitwise the 2-D launch
// on it). BANK = false is the 2-D kernel.
template <int BM, int BN, int TM, int TN, bool BANK>
__global__ void __launch_bounds__(kThreads, 1)
analog_mvm_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ y, int M, int K, int N,
                        const float* r_dac_p, const float* r_adc_p,
                        const float* out_scale_p, float r_dac_h, float r_adc_h,
                        float out_scale_h, int b_dac, int b_adc, int span,
                        int multi, int apply_dac, const uint8_t* __restrict__ keep) {
  if constexpr (BANK) {
    const size_t e = blockIdx.z, mn = static_cast<size_t>(M) * N;
    x += e * M * K;
    w += e * K * N;
    y += e * mn;
    if (keep) keep += e * mn * ((K + span - 1) / span);
    if (out_scale_p) out_scale_p += e;
  }
  constexpr int TX = BN / TN, TY = kThreads / TX;
  constexpr int A_PER = BM * kBK / kThreads, B_PER = kBK * BN / kThreads;
  static_assert(TY * TM == BM && TX * TN == BN, "the threads cover the tile");
  static_assert(A_PER * kThreads == BM * kBK && B_PER * kThreads == kBK * BN &&
                    BM % 4 == 0 && kBK % 8 == 0,
                "whole staging copies per thread");
  extern __shared__ __align__(16) float smem[];
  auto As = reinterpret_cast<float (*)[kBK][BM + kPad]>(smem);            // [2][kBK][BM + kPad]
  auto Bs = reinterpret_cast<float (*)[kBK][BN]>(smem + 2 * kBK * (BM + kPad));  // [2][kBK][BN]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float r_a, step_a;
  amvm::quant_range(r_adc_p ? *r_adc_p : r_adc_h, b_adc, r_a, step_a);
  float r_d = 0.f, step_d = 1.f;
  if (apply_dac) amvm::quant_range(r_dac_p ? *r_dac_p : r_dac_h, b_dac, r_d, step_d);
  const float out_scale = out_scale_p ? *out_scale_p : out_scale_h;
  const int n_tiles = (K + span - 1) / span;

  // x element e of a chunk (e = tid + it * 256) is row mm, k kk of it: a
  // warp copies 4 rows x 8 consecutive k (one 32-byte sector a row) into 32
  // distinct banks of the transposed tile
  auto a_pos = [](int e, int& kk, int& mm) {
    const int g = e >> 5;
    kk = (g % (kBK / 8)) * 8 + (e & 7);
    mm = (g / (kBK / 8)) * 4 + ((e >> 3) & 3);
  };
  // chunk [kb, kb + kBK) of the crossbar tile ending at t1 into buffer buf:
  // this thread's x elements (a_pos) and w elements (row e / BN, column
  // e % BN)
  auto issue = [&](int buf, int kb, int t1) {
#pragma unroll
    for (int it = 0; it < A_PER; ++it) {
      int kk, mm;
      a_pos(tid + it * kThreads, kk, mm);
      const int m = m0 + mm, k = kb + kk;
      const bool ok = m < M && k < t1;
      cp_async4(&As[buf][kk][mm], ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
#pragma unroll
    for (int it = 0; it < B_PER; ++it) {
      const int e = tid + it * kThreads, n = n0 + e % BN, k = kb + e / BN;
      const bool ok = k < t1 && n < N;
      cp_async4(&Bs[buf][e / BN][e % BN], ok ? w + static_cast<size_t>(k) * N + n : w, ok);
    }
    cp_async_commit();
  };

  float acc[TM][TN], part[TM][TN];
  for (int t0 = 0; t0 < K; t0 += span) {
    const int t1 = min(t0 + span, K);
    const int n_chunks = (t1 - t0 + kBK - 1) / kBK;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    issue(0, t0, t1);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      cp_async_wait_all();  // this thread's copies of chunk c landed
      if (apply_dac) {      // the DAC on the x values this thread copied (quant(0) is 0)
#pragma unroll
        for (int it = 0; it < A_PER; ++it) {
          int kk, mm;
          a_pos(tid + it * kThreads, kk, mm);
          float& v = As[buf][kk][mm];
          v = amvm::quant(v, r_d, step_d);
        }
      }
      // chunk c visible to all; every thread is done with chunk c - 1, whose
      // buffer the next copies overwrite
      __syncthreads();
      if (c + 1 < n_chunks) issue(buf ^ 1, t0 + (c + 1) * kBK, t1);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
      // one row of K: the outer product of this thread's x and w values
      auto fmas = [&](int kk) {
        float a[TM], b[TN];
        lds<TM>(&As[buf][kk][ty * TM], a);
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[buf][kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      };
      const int n_kk = min(kBK, t1 - t0 - c * kBK);  // rows of K the chunk holds
      if (n_kk == kBK) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) fmas(kk);
      } else {  // the tile's last chunk: the zero rows past its end add nothing
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          if (kk >= n_kk) break;
          fmas(kk);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    }
    __syncthreads();  // the next crossbar tile's first copies reuse buffer 0

    // the ADC of crossbar tile t on this thread's outputs; with several
    // tiles the running tile-serial sum lives in y
    const int t = t0 / span;
    const bool last = t1 >= K;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + TX * j;
        if (n >= N) continue;
        const size_t o = static_cast<size_t>(m) * N + n;
        const float p = acc[i][j];
        const bool q_it = !keep || keep[(static_cast<size_t>(m) * n_tiles + t) * N + n];
        const float q = q_it ? amvm::quant(p, r_a, step_a) : p;
        if (!multi) {
          y[o] = __fmul_rn(q, out_scale);
        } else {
          const float s = t == 0 ? q : __fadd_rn(y[o], q);
          y[o] = last ? __fmul_rn(s, out_scale) : s;
        }
      }
    }
  }
}

template <int BM, int BN>
constexpr int smem_bytes() {
  return 2 * kBK * (BM + kPad + BN) * static_cast<int>(sizeof(float));
}

using KernelFn = void (*)(const float*, const float*, float*, int, int, int, const float*,
                          const float*, const float*, float, float, float, int, int, int, int,
                          int, const uint8_t*);

struct Launch {
  KernelFn fn;
  int smem;
  cudaError_t attr;  // of allowing it smem bytes of dynamic shared memory
};

// one instantiation; above 48 KB a kernel takes dynamic shared memory only
// once allowed to (set once, thread-safe as a function-local static)
template <int BM, int BN, int TM, int TN, bool BANK>
Launch instance() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      analog_mvm_tiled_kernel<BM, BN, TM, TN, BANK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM, BN>());
  return {analog_mvm_tiled_kernel<BM, BN, TM, TN, BANK>, smem_bytes<BM, BN>(), attr};
}

// the instantiation of a (BM, BN) tile: TN = 4 (2 at BN = 16), TM = 8, 4 or
// 2 rows a thread
template <int BN, bool BANK>
Launch kernel_for(int bm) {
  constexpr int TN = BN == 16 ? 2 : 4;
  constexpr int TY = kThreads / (BN / TN);
  if (bm == 8 * TY) return instance<8 * TY, BN, 8, TN, BANK>();
  if (bm == 4 * TY) return instance<4 * TY, BN, 4, TN, BANK>();
  if (bm == 2 * TY) return instance<2 * TY, BN, 2, TN, BANK>();
  return {nullptr, 0, cudaSuccess};
}

template <bool BANK>
Launch launch_for(int bm, int bn) {
  switch (bn) {
    case 16: return kernel_for<16, BANK>(bm);
    case 32: return kernel_for<32, BANK>(bm);
    case 64: return kernel_for<64, BANK>(bm);
    case 128: return kernel_for<128, BANK>(bm);
    default: return {nullptr, 0, cudaSuccess};
  }
}

// the launch of E >= 1 problems (grid.z = E; the 2-D kernel at E = 0)
int launch(const void* x, const void* w, void* y, int E, int M, int K, int N,
           const void* r_dac_p, const void* r_adc_p, const void* out_scale_p, float r_dac_h,
           float r_adc_h, float out_scale_h, int b_dac, int b_adc, int span, int multi,
           int apply_dac, const void* keep, int bm, int bn, void* stream) {
  const Launch l = E ? launch_for<true>(bm, bn) : launch_for<false>(bm, bn);
  if (!l.fn || M < 1 || K < 1 || N < 1 || span < 1 || (!multi && span != K) ||
      (N + bn - 1) / bn > 65535 || E < 0 || E > 65535 || (E && apply_dac))
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.attr != cudaSuccess) return static_cast<int>(l.attr);
  const dim3 grid((M + bm - 1) / bm, (N + bn - 1) / bn, E ? E : 1);
  l.fn<<<grid, kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), M, K,
      N, static_cast<const float*>(r_dac_p), static_cast<const float*>(r_adc_p),
      static_cast<const float*>(out_scale_p), r_dac_h, r_adc_h, out_scale_h, b_dac, b_adc, span,
      multi, apply_dac, static_cast<const uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), w (K, N), y (M, N) fp32, contiguous; bn in {16, 32, 64, 128} and
// bm = TM x 256 / (bn / TN) for TM in {8, 4, 2} (TN = 4, or 2 at bn = 16);
// span = tile_rows when multi (per-tile ADC and K > tile_rows), else K.
// keep: null (serving), or the (M, ceil(K / span), N) uint8 quant-noise
// mask. A null range pointer takes the host value beside it. Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int analog_mvm_f32_launch(const void* x, const void* w, void* y, int M, int K, int N,
                                     const void* r_dac_p, const void* r_adc_p,
                                     const void* out_scale_p, float r_dac_h, float r_adc_h,
                                     float out_scale_h, int b_dac, int b_adc, int span,
                                     int multi, int apply_dac, const void* keep, int bm, int bn,
                                     void* stream) {
  return launch(x, w, y, 0, M, K, N, r_dac_p, r_adc_p, out_scale_p, r_dac_h, r_adc_h,
                out_scale_h, b_dac, b_adc, span, multi, apply_dac, keep, bm, bn, stream);
}

// The expert-bank form: E >= 1 problems of one shape, x (E, M, K), w (E, K,
// N), y (E, M, N), keep (E, M, T, N) or null, out_scale_p the (E,) GDC
// scalars (null: the host value for all); no DAC (x already quantized);
// the other rules as above.
extern "C" int analog_mvm_f32_bank_launch(const void* x, const void* w, void* y, int E, int M,
                                          int K, int N, const void* r_adc_p,
                                          const void* out_scale_p, float r_adc_h,
                                          float out_scale_h, int b_adc, int span, int multi,
                                          const void* keep, int bm, int bn, void* stream) {
  if (E < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, y, E, M, K, N, nullptr, r_adc_p, out_scale_p, 0.f, r_adc_h, out_scale_h,
                b_adc + 1, b_adc, span, multi, 0, keep, bm, bn, stream);
}

extern "C" const char* analog_mvm_f32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
