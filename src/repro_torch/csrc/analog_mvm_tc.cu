// Programmed analog-CiM MVM on Hopper's tensor cores (sm_90a), bf16: the
// crossbar-tiled MVM with the per-tile ADC in the epilogue, in two designs
// that share one per-element arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/analog_mvm.py::_kernel (launched
// by analog_mvm_fwd, pallas_call at analog_mvm.py:147) for bf16 operands
// without the DAC (the serving path passes x already quantized), and the
// bf16 training form above 16 rows (the prefill design with a quant-noise
// keep mask in its epilogue); fp32 runs the tiled design of
// analog_mvm_f32.cu, the DAC and shapes these kernels do not take the
// CUDA-core kernel of analog_mvm.cu (kernels/analog_mvm.py::select_design
// picks). It computes src/repro/core/engine.py::tile_matmul_quant:
//
//   for each crossbar tile t of `span` rows of K (the last one ragged):
//       s_c  = sum over the k16 steps of sub-chunk c, k ascending, of the
//              mma.sync m16n8k16 bf16 x bf16 products, accumulated in fp32
//              from zero                     (sub-chunk: kSub = 128 rows)
//       p_t  = ((0 + s_c0) + s_c1) + ...     (the tile's sub-chunks in order)
//       q_t  = (float)(bf16)quant(p_t)       (ADC, then the activation dtype)
//   y   = ((q_0 + q_1) + q_2) + ...          (tile-serial fp32)
//   out = (bf16)(y * out_scale)
//
// and, with one span (per_tile_adc off, or K <= tile_rows), out =
// (bf16)(quant(p_0) * out_scale) with no intermediate rounding. The
// quantizer is analog_mvm_core.cuh's (round half to even, _rn intrinsics).
//
// The PTX helpers, the ADC epilogue and the decode design's sub-chunk chain
// live in analog_mvm_tc_core.cuh, which B2's tensor-core MVM item
// (decode_fused.cu) includes too: the two compute each element with the
// same instructions in the same order, so they cannot drift apart.
//
// Why sub-chunks: the decode design must put several hundred blocks in
// flight, so it splits K below the crossbar tile; the prefill design splits
// its fp32 chain at the same 128-row boundaries. Every output element then
// sees the same mma instructions on the same operands in the same order in
// both designs, so a row's bits depend on neither M, the padding rows
// beside it, nor which design ran it: exact-length and bucketed prefill,
// and decode, agree bit for bit. Both run only the k16 steps that hold a
// real row of K (the last one zero-padded).
//
// Why mma.sync and not wgmma: identical per-element arithmetic across the
// two designs needs one instruction shape, and the decode design's tile (M
// <= 16 rows) is far below wgmma's 64. At the prefill shapes (M = 128-256,
// K = 2048-5632) the bound is the weight bytes and the operations about
// equally (the bf16 ridge); mma.sync's rate is a fraction of wgmma's but the
// design's first aim is to read each weight once per 64 rows of M instead
// of once per 8, and to take the products off the CUDA cores.
//
// Prefill design (M > 16): a 128 x 64 output tile per block of 8 warps (4 x
// 2 warp tiles of 32 x 32); x and w tiles of 64 rows of K stream through a
// 4-stage cp.async ring in shared memory (16-byte copies, XOR-swizzled rows
// read by ldmatrix, w transposed by ldmatrix.trans; each k16 step's
// fragments are loaded while the previous step's mma run); fp32 register
// accumulators per element for the sub-chunk chain, the crossbar tile's sum
// and the tile-serial output sum. Every weight is read once per 128 rows of
// M. Where the output tiles alone are too few to fill the card (M = 128-256
// on all but the lm_head), K is split at its crossbar tiles, one block each:
// each split's partial is then ADC-complete, and the last block of an
// output tile to finish sums the quantized partials in tile order, exactly
// the sum one block would have made (kernels/analog_mvm.py::prefill_plan).
//
// Decode design (M <= 16): bytes-bound (each weight read once, 2 operations
// per weight byte at M = 8). One block per (strip of 16 x W columns,
// sub-chunk of 128 rows of K), W warps of 16 columns each: x (padded to 16
// rows with zeros) and the weight sub-chunk are copied to shared memory at
// once, so a block's whole share of the weight stream is in flight, and the
// grid is (N / 16W) x (K / 128) blocks, several hundred on every tinyllama
// projection (kernels/analog_mvm.py::split_plan picks W). Each block writes
// its fp32 sub-chunk partials to a workspace; the last block of a strip to
// finish (arrival flags per strip) sums them in sub-chunk
// order, 16 sub-chunks' loads in flight, and applies the ADC epilogue -- the
// order is fixed, whatever order the blocks ran in. The partials and the
// arrival flags are the call's own workspace, so calls that overlap in
// time (two streams, two graphs) share nothing; see last_to_finish for why
// the flags need no zeroing.
//
// Expert-bank form (a MoE layer's family, kernels/analog_mvm.py::
// analog_mvm_bank): E problems of one shape (E, M, K) x (E, K, N), each
// expert its own GDC scalar, in ONE launch of either design: the expert is
// the grid's z (times the prefill design's splits). Its blocks run the
// 2-D design's block code (prefill_tile, decode_strip) on the expert's
// operands, so each expert's slice is bitwise the 2-D launch on it; the
// launch replaces E launches (3 x 16 a phi3.5-moe layer), which at decode
// (M = 8 slots) each stream a 4096 x 6400 weight, bytes-bound as the 2-D
// decode design is.
//
// The kernels allocate nothing and run on the caller's stream; the
// launchers return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "analog_mvm_core.cuh"
#include "analog_mvm_tc_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using amvm_tc::Adc;
using amvm_tc::cp_async16;
using amvm_tc::cp_async_commit;
using amvm_tc::cp_async_wait;
using amvm_tc::kSub;
using amvm_tc::ldsm_x4;
using amvm_tc::ldsm_x4_t;
using amvm_tc::make_adc;
using amvm_tc::mma_bf16;
using amvm_tc::smem_u32;
using amvm_tc::swz;

// four consecutive outputs (8-byte aligned) as bf16
__device__ __forceinline__ void store4(bf16* dst, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// ------------------------------------------------------------ prefill design

constexpr int kBM = 128, kBN = 64, kBK = 64;  // block tile; K rows per stage
constexpr int kStages = 4;
constexpr int kPThreads = 256;  // 8 warps as 4 (M) x 2 (N), 32 x 32 each
constexpr int kAChunks = kBM * 8, kBChunks = kBK * 8;  // 16-byte chunks per stage
constexpr int kStageBytes = (kAChunks + kBChunks) * 16;
constexpr int kPrefillSmem = kStages * kStageBytes;
static_assert(kAChunks % kPThreads == 0 && kBChunks % kPThreads == 0, "whole copies per thread");

// The sum of a strip's or tile's split partials, in split order, by the last
// block to finish it: every block stores its values to part[z][m][n], then
// raises its arrival flag, and a block that then sees every flag of its
// strip or tile raised reads them all back.
//
// The flags (one 64-bit word per block of a split strip or tile) lie in the
// call's own workspace, which holds whatever an earlier user of the memory
// left, so no call shares them with another (two streams, two graphs) and
// nothing zeroes them: a flag is raised when it holds this call's 64-bit
// tag (distinct for every call the wrapper makes, kernels/analog_mvm.py::
// _tag). No atomics: each block stores its flag, fences (fence.sc.gpu) and
// loads all the flags (spread over a warp's lanes, after a warp barrier);
// the block whose fence comes last in the fences' total order sees them
// all. Two blocks may both see them: both then sum the same partials in
// the same order and store the same bits. The summing block lowers the
// flags (~tag), so a CUDA graph replaying the launch (same tag, same
// workspace) starts afresh. Stale bytes that spell this call's tag where a
// flag is not yet raised would start the sum early: 2^-64 per flag for
// bytes not made to match. The price is one more round trip to L2 than an
// atomic counter shared by all calls: +0.18 ms per 155-launch decode step
// on an H100 (a memset of per-call counters cost +0.40 ms).
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool last_to_finish(unsigned long long* flags, unsigned long long tag,
                                               int splits, int me) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0: one flag store, then the loads spread over its lanes
    const int lane = threadIdx.x;
    if (lane == 0) {
      st_relaxed(flags + me, tag);
      __threadfence();
    }
    __syncwarp();
    bool all = true;
    for (int i = lane; i < splits; i += 32) all &= ld_relaxed(flags + i) == tag;
    all = __all_sync(0xffffffffu, all);
    if (all)
      for (int i = lane; i < splits; i += 32) st_relaxed(flags + i, ~tag);
    if (lane == 0) is_last = all;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// two blocks an SM (at most 128 registers a thread): 16 warps to overlap one
// block's ldmatrix and mma latency with the other's. KEEP: the training
// form, keep the (M, T, N) uint8 quant-noise mask (T crossbar tiles of K
// when multi, else 1) -- its ADC selects quant(p) where the mask is set
// and p where it is not (Adc::tile_q_keep, finish_keep); each split applies
// its own tile's mask before it writes its partial. KEEP = false is the
// serving form, and compiles to the instructions it had before the mask.
//
// The block's work is prefill_tile, one (M, K) x (K, N) problem's output
// tile (blockIdx.x, blockIdx.y) and split z of `splits`: the serving kernel
// runs it on grid.z = the splits, the expert-bank kernel on grid.z =
// experts x splits, each expert its own operands at its own offsets. Both
// run the same instructions per element, so an expert's slice of a bank
// launch is bitwise the 2-D launch on that slice.
template <bool KEEP>
__device__ __forceinline__ void prefill_tile(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w, bf16* __restrict__ y,
                                             float* __restrict__ part,
                                             unsigned long long* __restrict__ flags,
                                             unsigned long long tag, int M, int K, int N,
                                             const float* r_adc_p, const float* out_scale_p,
                                             float r_adc_h, float out_scale_h, int b_adc,
                                             int span, int multi,
                                             const uint8_t* __restrict__ keep, const int splits,
                                             const int z) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  // a split is one crossbar tile (multi); one split walks all of K
  const int k_lo = splits > 1 ? z * span : 0;
  const int k_hi = splits > 1 ? min(k_lo + span, K) : K;
  const Adc adc = make_adc(r_adc_p, out_scale_p, r_adc_h, out_scale_h, b_adc, multi);
  const int nst = (k_hi - k_lo + kBK - 1) / kBK;
  // the training form: whether element (mi, ni, e)'s ADC conversion of
  // crossbar tile t quantizes (outside M x N it does not matter)
  const int n_tiles = multi ? (K + span - 1) / span : 1;
  auto kept = [&](int mi, int ni, int e, int t) {
    const int m = m0 + wm * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
    const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2 + (e & 1);
    return m >= M || n >= N || keep[(static_cast<size_t>(m) * n_tiles + t) * N + n] != 0;
  };

  // stage s holds x[m0:m0+128, kb:kb+64] (A) and w[kb:kb+64, n0:n0+64] (B)
  auto load_stage = [&](int s) {
    const uint32_t a_s = sbase + (s % kStages) * kStageBytes;
    const uint32_t b_s = a_s + kAChunks * 16;
    const int kb = k_lo + s * kBK;
#pragma unroll
    for (int it = 0; it < kAChunks / kPThreads; ++it) {
      const int i = tid + it * kPThreads, r = i >> 3, c = i & 7;
      const int m = m0 + r, k = kb + c * 8;
      const bool ok = m < M && k < k_hi;
      cp_async16(a_s + swz(r, c) * 16, x + (ok ? static_cast<size_t>(m) * K + k : 0), ok);
    }
#pragma unroll
    for (int it = 0; it < kBChunks / kPThreads; ++it) {
      const int i = tid + it * kPThreads, r = i >> 3, c = i & 7;
      const int k = kb + r, n = n0 + c * 8;
      const bool ok = k < k_hi && n < N;
      cp_async16(b_s + swz(r, c) * 16, w + (ok ? static_cast<size_t>(k) * N + n : 0), ok);
    }
  };
  // the A and B fragments of k16 step kk of a stage
  auto load_frags = [&](uint32_t a_s, uint32_t b_s, int kk, uint32_t (&a)[2][4],
                        uint32_t (&b)[2][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(a_s + swz(wm * 32 + mi * 16 + (lane & 15), kk * 2 + (lane >> 4)) * 16, a[mi]);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldsm_x4_t(b_s + swz(kk * 16 + (lane & 15), wn * 4 + nj * 2 + (lane >> 4)) * 16, b[nj]);
  };

  float sub[2][4][4], tile[2][4][4], yacc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sub[i][j][e] = tile[i][j][e] = yacc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }

  int t_idx = 0;  // crossbar tiles finished by this block
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + kStages - 1 < nst) load_stage(s + kStages - 1);
    cp_async_commit();

    const uint32_t a_s = sbase + (s % kStages) * kStageBytes;
    const uint32_t b_s = a_s + kAChunks * 16;
    const int kb = k_lo + s * kBK;
    const int nk = min(kBK / 16, (k_hi - kb + 15) / 16);  // k16 steps holding a real row
    uint32_t a[2][2][4], b[2][2][4];  // fragments, double-buffered over kk
    load_frags(a_s, b_s, 0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk < nk) {
        if (kk + 1 < nk) load_frags(a_s, b_s, kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(sub[mi][ni], a[kk & 1][mi], b[kk & 1][ni >> 1][(ni & 1) * 2],
                     b[kk & 1][ni >> 1][(ni & 1) * 2 + 1]);
      }
    }

    const int k_next = kb + kBK;
    const bool sub_end = (k_next % kSub == 0) || k_next >= k_hi;
    const bool tile_end = k_next >= k_hi || (multi && k_next % span == 0);
    if (sub_end) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tile[i][j][e] = __fadd_rn(tile[i][j][e], sub[i][j][e]);
            sub[i][j][e] = 0.f;
          }
    }
    if (tile_end && multi) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float q;
            if constexpr (KEEP)  // a split's tile is z, one block's t_idx
              q = adc.tile_q_keep(tile[i][j][e], kept(i, j, e, z + t_idx));
            else
              q = adc.tile_q(tile[i][j][e]);
            yacc[i][j][e] = t_idx == 0 ? q : __fadd_rn(yacc[i][j][e], q);
            tile[i][j][e] = 0.f;
          }
      ++t_idx;
    }
  }
  cp_async_wait<0>();

  // C fragment: e = 0, 1 at row lane / 4, e = 2, 3 eight rows below;
  // columns 2 (lane % 4) + (e & 1). One split: the output; several: this
  // tile's quantized partial (yacc holds it alone) to the workspace.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mi * 16 + (lane >> 2) + h * 8;
        const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        if (m >= M || n >= N) continue;  // N % 8 == 0: n + 1 < N too
        if (splits > 1) {
          float2* dst = reinterpret_cast<float2*>(
              part + (static_cast<size_t>(z) * M + m) * N + n);
          __stcg(dst, make_float2(yacc[mi][ni][2 * h], yacc[mi][ni][2 * h + 1]));
          continue;
        }
        float o0, o1;
        if constexpr (KEEP) {  // one conversion over all of K reads tile 0's mask
          o0 = adc.finish_keep(yacc[mi][ni][2 * h], tile[mi][ni][2 * h],
                               multi || kept(mi, ni, 2 * h, 0));
          o1 = adc.finish_keep(yacc[mi][ni][2 * h + 1], tile[mi][ni][2 * h + 1],
                               multi || kept(mi, ni, 2 * h + 1, 0));
        } else {
          o0 = adc.finish(yacc[mi][ni][2 * h], tile[mi][ni][2 * h]);
          o1 = adc.finish(yacc[mi][ni][2 * h + 1], tile[mi][ni][2 * h + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(m) * N + n) =
            __floats2bfloat162_rn(o0, o1);
      }
  if (splits == 1 ||
      !last_to_finish(flags + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * splits,
                      tag, splits, z))
    return;

  // the tile's last block: y = ((q_0 + q_1) + ...) * out_scale, 4 columns a thread
  const size_t stride = static_cast<size_t>(M) * N;
  for (int i = tid; i < kBM * kBN / 4; i += kPThreads) {
    const int m = m0 + i / (kBN / 4), n = n0 + (i % (kBN / 4)) * 4;
    if (m >= M || n >= N) continue;  // N % 8 == 0: the 4 columns are all < N
    const float* p = part + static_cast<size_t>(m) * N + n;
    float4 v[8];
    float4 acc = __ldcg(reinterpret_cast<const float4*>(p));
    for (int t0 = 1; t0 < splits; t0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (t0 + u < splits) v[u] = __ldcg(reinterpret_cast<const float4*>(p + (t0 + u) * stride));
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (t0 + u < splits) {
          acc.x = __fadd_rn(acc.x, v[u].x);
          acc.y = __fadd_rn(acc.y, v[u].y);
          acc.z = __fadd_rn(acc.z, v[u].z);
          acc.w = __fadd_rn(acc.w, v[u].w);
        }
    }
    store4(y + static_cast<size_t>(m) * N + n, adc.finish(acc.x, 0.f), adc.finish(acc.y, 0.f),
           adc.finish(acc.z, 0.f), adc.finish(acc.w, 0.f));
  }
}

template <bool KEEP>
__global__ void __launch_bounds__(kPThreads, 2)
analog_mvm_prefill_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          bf16* __restrict__ y, float* __restrict__ part,
                          unsigned long long* __restrict__ flags,
                          unsigned long long tag, int M, int K, int N,
                          const float* r_adc_p, const float* out_scale_p, float r_adc_h,
                          float out_scale_h, int b_adc, int span, int multi,
                          const uint8_t* __restrict__ keep) {
  prefill_tile<KEEP>(x, w, y, part, flags, tag, M, K, N, r_adc_p, out_scale_p, r_adc_h,
                     out_scale_h, b_adc, span, multi, keep, gridDim.z, blockIdx.z);
}

// The expert-bank form: grid.z = experts x splits; expert e = blockIdx.z /
// splits reads x[e] (M, K), w[e] (K, N), out_scale_p[e] and keep[e] (M, T,
// N), writes y[e] (M, N), and owns `stride` floats of the workspace (its
// partials, then its flags, as one 2-D call's).
template <bool KEEP>
__global__ void __launch_bounds__(kPThreads, 2)
analog_mvm_prefill_bank_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                               bf16* __restrict__ y, float* __restrict__ part,
                               unsigned long long* __restrict__ flags,
                               unsigned long long tag, int M, int K, int N,
                               const float* r_adc_p, const float* out_scale_p, float r_adc_h,
                               float out_scale_h, int b_adc, int span, int multi,
                               const uint8_t* __restrict__ keep, int splits, size_t stride) {
  const int e = blockIdx.z / splits;
  const size_t mn = static_cast<size_t>(M) * N;
  const int n_tiles = multi ? (K + span - 1) / span : 1;
  prefill_tile<KEEP>(
      x + e * static_cast<size_t>(M) * K, w + e * static_cast<size_t>(K) * N, y + e * mn,
      part + e * stride,
      reinterpret_cast<unsigned long long*>(reinterpret_cast<float*>(flags) + e * stride), tag,
      M, K, N, r_adc_p, out_scale_p ? out_scale_p + e : nullptr, r_adc_h, out_scale_h, b_adc,
      span, multi, keep ? keep + e * mn * n_tiles : nullptr, splits, blockIdx.z % splits);
}

// ------------------------------------------------------------ decode design

constexpr int kDRows = 16;             // x rows, zero-padded past M
constexpr int kXChunks = kSub / 8;     // 16-byte chunks of an x row (16)

// One block's strip and sub-chunk (blockIdx.x, blockIdx.y) of one (M, K) x
// (K, N) problem: the serving kernel's, and each expert's of the bank
// kernel (grid.z = experts), as for the prefill design.
template <int W>
__device__ __forceinline__ void decode_strip(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w, bf16* __restrict__ y,
                                             float* __restrict__ part,
                                             unsigned long long* __restrict__ flags,
                                             unsigned long long tag, int M, int K, int N,
                                             const float* r_adc_p, const float* out_scale_p,
                                             float r_adc_h, float out_scale_h, int b_adc,
                                             int span, int multi) {
  constexpr int kCols = 16 * W;        // columns of the block's strip
  constexpr int kWChunks = kCols / 8;  // 16-byte chunks of a weight row
  constexpr int kWMask = (kWChunks < 8 ? kWChunks : 8) - 1;
  __shared__ __align__(128) bf16 xs[kDRows * kSub];
  __shared__ __align__(128) bf16 wsm[kSub * kCols];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = blockIdx.x, c = blockIdx.y, n_sub = gridDim.y;
  const int n0 = strip * kCols, c0 = c * kSub, c1 = min(c0 + kSub, K);
  const uint32_t xs_s = smem_u32(xs), ws_s = smem_u32(wsm);
  // chunk ch of row r at (ch ^ (r & mask)), as in the prefill design
  auto xsw = [](int r, int ch) { return r * kXChunks + (ch ^ (r & 7)); };
  auto wsw = [](int r, int ch) { return r * kWChunks + (ch ^ (r & kWMask)); };

  // x rows (16 x 128) and the weight sub-chunk (128 x kCols), all in flight
#pragma unroll
  for (int it = 0; it < kDRows * kXChunks / (32 * W); ++it) {
    const int i = tid + it * 32 * W, r = i / kXChunks, ch = i % kXChunks, k = c0 + ch * 8;
    const bool ok = r < M && k < c1;
    cp_async16(xs_s + xsw(r, ch) * 16, x + (ok ? static_cast<size_t>(r) * K + k : 0), ok);
  }
#pragma unroll
  for (int it = 0; it < kSub * kWChunks / (32 * W); ++it) {
    const int i = tid + it * 32 * W, r = i / kWChunks, ch = i % kWChunks;
    const int k = c0 + r, n = n0 + ch * 8;
    const bool ok = k < c1 && n < N;
    cp_async16(ws_s + wsw(r, ch) * 16, w + (ok ? static_cast<size_t>(k) * N + n : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's two 8-column groups share each A fragment
  float acc[2][4];
  amvm_tc::sub_chain<2>(
      acc, (c1 - c0 + 15) / 16,
      [&](int kk, uint32_t (&a)[4]) {
        ldsm_x4(xs_s + xsw(lane & 15, kk * 2 + (lane >> 4)) * 16, a);
      },
      [&](int kk, uint32_t (&b)[4]) {
        ldsm_x4_t(ws_s + wsw(kk * 16 + (lane & 15), warp * 2 + (lane >> 4)) * 16, b);
      });

  // this sub-chunk's fp32 partials of the real rows: part[c][m][n]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (lane >> 2) + h * 8;
      const int n = n0 + warp * 16 + j * 8 + (lane & 3) * 2;
      if (m < M && n < N)
        __stcg(reinterpret_cast<float2*>(part + (static_cast<size_t>(c) * M + m) * N + n),
               make_float2(acc[j][2 * h], acc[j][2 * h + 1]));
    }
  if (!last_to_finish(flags + static_cast<size_t>(strip) * n_sub, tag, n_sub, c)) return;

  // the strip's last block: sub-chunks summed in order 0, 1, ..., the ADC
  // at each crossbar tile's end, tile-serial output sum; 4 columns a thread,
  // 16 sub-chunks' loads in flight at once
  const Adc adc = make_adc(r_adc_p, out_scale_p, r_adc_h, out_scale_h, b_adc, multi);
  const size_t stride = static_cast<size_t>(M) * N;
  for (int i = tid; i < M * kCols / 4; i += 32 * W) {
    const int m = i / (kCols / 4), n = n0 + (i % (kCols / 4)) * 4;
    if (n >= N) continue;  // N % 8 == 0: the 4 columns are all < N
    const float* p = part + static_cast<size_t>(m) * N + n;
    float tile[4] = {0.f, 0.f, 0.f, 0.f}, yv[4] = {0.f, 0.f, 0.f, 0.f};
    int t_idx = 0;
    for (int cb = 0; cb < n_sub; cb += 16) {
      float4 v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (cb + u < n_sub) v[u] = __ldcg(reinterpret_cast<const float4*>(p + (cb + u) * stride));
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int cc = cb + u;
        if (cc >= n_sub) break;
        const float vv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) tile[q] = __fadd_rn(tile[q], vv[q]);
        const int k_next = (cc + 1) * kSub;
        if (multi && (k_next >= K || k_next % span == 0)) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float qv = adc.tile_q(tile[q]);
            yv[q] = t_idx == 0 ? qv : __fadd_rn(yv[q], qv);
            tile[q] = 0.f;
          }
          ++t_idx;
        }
      }
    }
    store4(y + static_cast<size_t>(m) * N + n, adc.finish(yv[0], tile[0]),
           adc.finish(yv[1], tile[1]), adc.finish(yv[2], tile[2]), adc.finish(yv[3], tile[3]));
  }
}

template <int W>
__global__ void __launch_bounds__(32 * W)
analog_mvm_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         bf16* __restrict__ y, float* __restrict__ part,
                         unsigned long long* __restrict__ flags,
                         unsigned long long tag, int M, int K, int N,
                         const float* r_adc_p, const float* out_scale_p, float r_adc_h,
                         float out_scale_h, int b_adc, int span, int multi) {
  decode_strip<W>(x, w, y, part, flags, tag, M, K, N, r_adc_p, out_scale_p, r_adc_h,
                  out_scale_h, b_adc, span, multi);
}

// The expert-bank form of the decode design: expert e = blockIdx.z, its
// operands and its `stride` floats of workspace as in the prefill bank
// kernel.
template <int W>
__global__ void __launch_bounds__(32 * W)
analog_mvm_decode_bank_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                              bf16* __restrict__ y, float* __restrict__ part,
                              unsigned long long* __restrict__ flags,
                              unsigned long long tag, int M, int K, int N,
                              const float* r_adc_p, const float* out_scale_p, float r_adc_h,
                              float out_scale_h, int b_adc, int span, int multi,
                              size_t stride) {
  const int e = blockIdx.z;
  decode_strip<W>(
      x + e * static_cast<size_t>(M) * K, w + e * static_cast<size_t>(K) * N,
      y + e * static_cast<size_t>(M) * N, part + e * stride,
      reinterpret_cast<unsigned long long*>(reinterpret_cast<float*>(flags) + e * stride), tag,
      M, K, N, r_adc_p, out_scale_p ? out_scale_p + e : nullptr, r_adc_h, out_scale_h, b_adc,
      span, multi);
}

template <bool KEEP>
int launch_prefill(const void* x, const void* w, void* y, void* part, void* flags,
                   unsigned long long tag, int M, int K, int N, const void* r_adc_p,
                   const void* out_scale_p, float r_adc_h, float out_scale_h, int b_adc,
                   int span, int multi, int splits, const void* keep, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(analog_mvm_prefill_kernel<KEEP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kPrefillSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  analog_mvm_prefill_kernel<KEEP><<<grid, kPThreads, kPrefillSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),
      static_cast<float*>(part), static_cast<unsigned long long*>(flags), tag, M, K, N,
      static_cast<const float*>(r_adc_p), static_cast<const float*>(out_scale_p), r_adc_h,
      out_scale_h, b_adc, span, multi, static_cast<const uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

template <bool KEEP>
int launch_prefill_bank(const void* x, const void* w, void* y, void* part, void* flags,
                        unsigned long long tag, int E, int M, int K, int N, const void* r_adc_p,
                        const void* out_scale_p, float r_adc_h, float out_scale_h, int b_adc,
                        int span, int multi, int splits, const void* keep, size_t stride,
                        cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(analog_mvm_prefill_bank_kernel<KEEP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kPrefillSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E * splits);
  analog_mvm_prefill_bank_kernel<KEEP><<<grid, kPThreads, kPrefillSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),
      static_cast<float*>(part), static_cast<unsigned long long*>(flags), tag, M, K, N,
      static_cast<const float*>(r_adc_p), static_cast<const float*>(out_scale_p), r_adc_h,
      out_scale_h, b_adc, span, multi, static_cast<const uint8_t*>(keep), splits, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Prefill design. x (M, K), w (K, N), y (M, N) bf16, contiguous, 16-byte
// aligned; K % 8 == 0, N % 8 == 0; span = tile_rows when multi, else K, and
// span % 128 == 0 when multi. splits: 1, or (multi only) the crossbar tiles
// of K, one block per tile, summed by the last to finish through part
// (splits x M x N fp32) and flags (splits 8-byte-aligned 64-bit words per
// 128 x 64 output tile, any contents; `tag` this call's own, see
// last_to_finish). keep: null (serving), or the training form's (M, T, N)
// uint8 quant-noise mask, T = ceil(K / span) when multi, else 1. A null
// range pointer takes the host value beside it. Returns cudaGetLastError()
// after the launch (0 = ok).
extern "C" int analog_mvm_tc_prefill(const void* x, const void* w, void* y, void* part,
                                     void* flags, unsigned long long tag, int M, int K,
                                     int N, const void* r_adc_p, const void* out_scale_p,
                                     float r_adc_h, float out_scale_h, int b_adc, int span,
                                     int multi, int splits, const void* keep, void* stream) {
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 8 || (multi && span % kSub) || splits < 1 ||
      reinterpret_cast<uintptr_t>(flags) % 8 ||
      (splits > 1 && (!multi || splits != (K + span - 1) / span)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return keep ? launch_prefill<true>(x, w, y, part, flags, tag, M, K, N, r_adc_p, out_scale_p,
                                     r_adc_h, out_scale_h, b_adc, span, multi, splits, keep, s)
              : launch_prefill<false>(x, w, y, part, flags, tag, M, K, N, r_adc_p, out_scale_p,
                                      r_adc_h, out_scale_h, b_adc, span, multi, splits, keep, s);
}

// Decode design, M <= 16; the same operand rules. part: ceil(K / 128) x M x
// N fp32 workspace; flags: ceil(K / 128) 64-bit words per strip of 16 x
// warps columns, as for the prefill design. warps in {1, 2, 4}.
extern "C" int analog_mvm_tc_decode(const void* x, const void* w, void* y, void* part,
                                    void* flags, unsigned long long tag, int M, int K,
                                    int N, const void* r_adc_p, const void* out_scale_p,
                                    float r_adc_h, float out_scale_h, int b_adc, int span,
                                    int multi, int warps, void* stream) {
  const int n_sub = (K + kSub - 1) / kSub;
  if (M < 1 || M > kDRows || K < 1 || N < 1 || K % 8 || N % 8 || (multi && span % kSub) ||
      reinterpret_cast<uintptr_t>(flags) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMVM_DECODE(WW)                                                                    \
  analog_mvm_decode_kernel<WW><<<dim3((N + 16 * WW - 1) / (16 * WW), n_sub), 32 * WW, 0, s>>>(        \
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),     \
      static_cast<float*>(part), static_cast<unsigned long long*>(flags), tag, M, K, N,     \
      static_cast<const float*>(r_adc_p), static_cast<const float*>(out_scale_p), r_adc_h, \
      out_scale_h, b_adc, span, multi)
  if (warps == 1)
    AMVM_DECODE(1);
  else if (warps == 2)
    AMVM_DECODE(2);
  else if (warps == 4)
    AMVM_DECODE(4);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef AMVM_DECODE
  return static_cast<int>(cudaGetLastError());
}

// Expert-bank forms: E problems of one shape in one launch, expert e's x
// at x + e M K, w at w + e K N, y at y + e M N, keep (when given) at keep +
// e M T N, its GDC scalar out_scale_p[e] (null: the host value for all),
// and `stride` floats of the workspace at part + e stride holding what one
// 2-D call of the design holds (its partials, then its flags at the same
// offset from its start as `flags` from part); stride % 4 == 0. The other
// operands and rules are the 2-D launchers'. Returns cudaGetLastError().
extern "C" int analog_mvm_tc_prefill_bank(const void* x, const void* w, void* y, void* part,
                                          void* flags, unsigned long long tag, int E, int M,
                                          int K, int N, const void* r_adc_p,
                                          const void* out_scale_p, float r_adc_h,
                                          float out_scale_h, int b_adc, int span, int multi,
                                          int splits, const void* keep,
                                          unsigned long long stride, void* stream) {
  if (E < 1 || M < 1 || K < 1 || N < 1 || K % 8 || N % 8 || (multi && span % kSub) ||
      splits < 1 || static_cast<long long>(E) * splits > 65535 || stride % 4 ||
      reinterpret_cast<uintptr_t>(flags) % 8 ||
      (splits > 1 && (!multi || splits != (K + span - 1) / span)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return keep ? launch_prefill_bank<true>(x, w, y, part, flags, tag, E, M, K, N, r_adc_p,
                                          out_scale_p, r_adc_h, out_scale_h, b_adc, span, multi,
                                          splits, keep, stride, s)
              : launch_prefill_bank<false>(x, w, y, part, flags, tag, E, M, K, N, r_adc_p,
                                           out_scale_p, r_adc_h, out_scale_h, b_adc, span,
                                           multi, splits, keep, stride, s);
}

extern "C" int analog_mvm_tc_decode_bank(const void* x, const void* w, void* y, void* part,
                                         void* flags, unsigned long long tag, int E, int M,
                                         int K, int N, const void* r_adc_p,
                                         const void* out_scale_p, float r_adc_h,
                                         float out_scale_h, int b_adc, int span, int multi,
                                         int warps, unsigned long long stride, void* stream) {
  const int n_sub = (K + kSub - 1) / kSub;
  if (E < 1 || E > 65535 || M < 1 || M > kDRows || K < 1 || N < 1 || K % 8 || N % 8 ||
      (multi && span % kSub) || stride % 4 || reinterpret_cast<uintptr_t>(flags) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMVM_DECODE_BANK(WW)                                                                 \
  analog_mvm_decode_bank_kernel<WW>                                                          \
      <<<dim3((N + 16 * WW - 1) / (16 * WW), n_sub, E), 32 * WW, 0, s>>>(                    \
          static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),  \
          static_cast<float*>(part), static_cast<unsigned long long*>(flags), tag, M, K, N,  \
          static_cast<const float*>(r_adc_p), static_cast<const float*>(out_scale_p),        \
          r_adc_h, out_scale_h, b_adc, span, multi, stride)
  if (warps == 1)
    AMVM_DECODE_BANK(1);
  else if (warps == 2)
    AMVM_DECODE_BANK(2);
  else if (warps == 4)
    AMVM_DECODE_BANK(4);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef AMVM_DECODE_BANK
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* analog_mvm_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
