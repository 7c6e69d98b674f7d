// The whole programmed decode step of a dense LM in ONE launch, for Hopper
// (sm_90a): L x (RMSNorm -> wq/wk/wv -> RoPE -> K/V row write -> GQA decode
// attention -> wo + residual -> RMSNorm -> silu(w1) * w3 -> w2 + residual),
// then the final norm and the lm_head, for B slots.
//
// Replaces the TPU kernel src/repro/kernels/decode_fused.py::_decode_kernel
// (pallas_call at decode_fused.py:386). Its plain version is
// src/repro_torch/kernels/ref.py::decode_fused_ref; each programmed MVM is
// what analog_mvm.cu computes, with the same device code
// (analog_mvm_core.cuh):
//
//   x_q  = (T)fake_quant(x, r_dac, b_adc + 1)    DAC, Eq. 5 range
//                                                r_dac = |r_adc||S|/(|w_max|+1e-9)
//   q_t  = fake_quant(x_q[tile t] @ w[tile t], r_adc, b_adc)   ADC per
//          1024-row crossbar tile (rounded to T when K spans several tiles)
//   y    = (T)(((q_0 + q_1) + ...) * out_scale)  tile-serial fp32 sum, GDC
//
// Rounding to the activation dtype T happens where the per-layer PyTorch
// path rounds: after every norm, projection, RoPE, attention output,
// residual add, silu and gate product.
//
// Schedule. One cooperative launch of a persistent grid (every block the
// card holds at once); grid-wide barriers separate the dependent phases.
// Per layer:
//   1 row    per slot: residual add of the previous layer's w2 output,
//            RMSNorm, the DAC of wq/wk/wv (three quantized copies)
//   2 mvm    wq, wk, wv tile partials
//   3 attn   per (slot, head): sum the q/k/v partials, RoPE, write the K/V
//            row (the block of the group's first head), scores, softmax,
//            the AV product, the DAC of wo
//   4 mvm    wo
//   5 row    residual add, RMSNorm, the DAC of w1 and w3
//   6 mvm    w1, w3
//   7 gate   silu(w1) * w3, the DAC of w2
//   8 mvm    w2
// then row (residual, final norm, DAC) -> mvm lm_head -> logits: 8 L + 2
// barriers per step. An mvm phase splits each projection into work items of
// (8 slots, 32 output columns, one crossbar tile of K): the ADC acts on
// each tile's partial independently, so splitting K at tile boundaries is
// exact as long as the consumer sums the quantized partials in tile order,
// which every consumer does. wk/wv (N = 256) thus run on 16 items each
// instead of 8, w2 (K = 5632) on 384.
//
// The K/V row goes to min(length, S - 1), as the per-layer path clamps it;
// attention covers positions < min(length + 1, S) and takes the new row
// from shared memory (its writer is another block of the same phase).
//
// Bound: at decode (B = 8) every weight is read once per step and used for
// 2 B flops per element: bytes over HBM bandwidth bound the step (2.07 GB
// of bf16 weights at tinyllama-1.1b: 0.62 ms at 3.35 TB/s). This first
// version keeps B1's CUDA-core GEMV inner loop (16-byte weight loads,
// fp32 FMA, no TF32, no tensor cores) and spends its design on removing
// the ~4,600 launches and host round trips of the per-layer step; TMA
// prefetch of layer l+1's weights and wgmma are later work.
//
// Inputs live on the device: the (L+1, 7, 3) f32 table of [r_adc, w_max,
// out_scale] with gain_s at [L, 1, 0], the slot lengths, the workspace
// (residual stream, DAC-quantized inputs, tile partials). Per-projection
// bitwidths and tile spans are launch arguments. The kernel allocates
// nothing and reads nothing back to the host.
//
// `phases` > 0 ends the launch at the barrier after that many phases (8 per
// layer in the order above, then the final row and the lm_head), with the
// workspace holding that phase's inputs and partials: the per-phase check
// (kernels/decode_fused_check.py) reads it there. 0 runs the whole step.

#include <cooperative_groups.h>

#include "analog_mvm_core.cuh"

namespace cg = cooperative_groups;

namespace {

using amvm::kCols;
using amvm::kRows;
using amvm::kThreads;
using amvm::kWarps;
using amvm::TileSmem;
using amvm::Traits;

constexpr int kProj = 7;  // wq wk wv wo w1 w3 w2 per layer; index 7 = lm_head
constexpr int kMaxHd = 256;
constexpr int kHead = 7;
enum { WQ = 0, WK, WV, WO, W1, W3, W2 };

template <typename T>
struct Args {
  const T* h0;          // (B, D) embedded tokens
  const int* lens;      // (B,) slot lengths
  int* lens_out;        // (B,) lengths + 1
  const float* tab;     // (L+1, 7, 3)
  const float* n1;      // (L, D)
  const float* n2;      // (L, D)
  const float* fin;     // (D,)
  const T* w[8];        // 7 stacks (L, K, N), then lm_head (D, V)
  T* kc;                // (L, B, S, KV, HD)
  T* vc;
  const float* freqs;   // (HD/2,) RoPE frequencies
  T* logits;            // (B, V)
  T* x;                 // (B, D) residual stream
  T* x1;                // (B, D) residual after attention
  T* xq;                // (3, xq_stride) DAC-quantized MVM inputs
  float* part;          // (3, part_stride) quantized tile partials
  int L, B, D, H, KV, HD, F, V, S;
  int bits[8], span[8], vec_ok[8];
  int xq_stride, part_stride;
  int phases;           // end after this many phases; 0 = the whole step
  float eps, attn_scale;
};

template <typename T>
__device__ __forceinline__ void proj_kn(const Args<T>& a, int p, int& K, int& N) {
  switch (p) {
    case WQ: K = a.D; N = a.H * a.HD; break;
    case WK:
    case WV: K = a.D; N = a.KV * a.HD; break;
    case WO: K = a.H * a.HD; N = a.D; break;
    case W1:
    case W3: K = a.D; N = a.F; break;
    case W2: K = a.F; N = a.D; break;
    default: K = a.D; N = a.V; break;  // lm_head
  }
}

template <typename T>
__device__ __forceinline__ int n_tiles(const Args<T>& a, int p) {
  int K, N;
  proj_kn(a, p, K, N);
  return (K + a.span[p] - 1) / a.span[p];
}

// table row of projection p at layer l (the lm_head sits at row L, col 0)
template <typename T>
__device__ __forceinline__ const float* scalars(const Args<T>& a, int l, int p) {
  return p == kHead ? a.tab + (a.L * kProj) * 3 : a.tab + (l * kProj + p) * 3;
}

// the DAC's fake-quant range and step of projection p (Eq. 5)
template <typename T>
__device__ __forceinline__ void dac_range(const Args<T>& a, int l, int p, float& r,
                                          float& step) {
  const float* t = scalars(a, l, p);
  const float gain_s = a.tab[(a.L * kProj + 1) * 3];
  const float r_dac = __fdiv_rn(__fmul_rn(fabsf(t[0]), fabsf(gain_s)),
                                __fadd_rn(fabsf(t[1]), 1e-9f));
  amvm::quant_range(r_dac, a.bits[p] + 1, r, step);
}

// output (m, n) of projection p: the quantized tile partials of `region`
// summed in tile order, times the GDC out_scale, rounded to T
template <typename T>
__device__ __forceinline__ float combine(const Args<T>& a, int region, int p,
                                         int l, int N, int m, int n) {
  const float* pr = a.part + static_cast<size_t>(region) * a.part_stride;
  const int tiles = n_tiles(a, p);
  const size_t plane = static_cast<size_t>(a.B) * N;
  const size_t at = static_cast<size_t>(m) * N + n;
  float y = pr[at];
  for (int t = 1; t < tiles; ++t) y = __fadd_rn(y, pr[t * plane + at]);
  return Traits<T>::round_trip(__fmul_rn(y, scalars(a, l, p)[2]));
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, scratch[w]);
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, scratch[w]);
  __syncthreads();
  return t;
}

// ---------------------------------------------------------------- phases

// Per slot: finish the residual, RMSNorm with `scale`, and write the DAC-
// quantized input of each projection in `projs` (row-major (B, D)) to the
// xq slots 0.. . `from` says where the residual comes from: 0 = the
// embedded tokens (layer 0), 1 = x1 + w2 output of layer l - 1 (into x),
// 2 = x + wo output of layer l (into x1).
template <typename T>
__device__ void row_phase(const Args<T>& a, float* scratch, int l, int from,
                          const float* scale, int n_proj, const int* projs,
                          int dac_layer) {
  constexpr int kPer = 32;  // D <= 256 * kPer
  float rq[3], sq[3];
  for (int j = 0; j < n_proj; ++j) dac_range(a, dac_layer, projs[j], rq[j], sq[j]);
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const size_t row = static_cast<size_t>(b) * a.D;
    float xv[kPer];
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      xv[u] = 0.f;
      if (i < a.D) {
        float v;
        if (from == 0) {
          v = Traits<T>::to_f(a.h0[row + i]);
          a.x[row + i] = a.h0[row + i];
        } else if (from == 1) {
          const float y = combine(a, 0, W2, l - 1, a.D, b, i);
          v = Traits<T>::round_trip(__fadd_rn(Traits<T>::to_f(a.x1[row + i]), y));
          a.x[row + i] = Traits<T>::from_f(v);
        } else {
          const float y = combine(a, 0, WO, l, a.D, b, i);
          v = Traits<T>::round_trip(__fadd_rn(Traits<T>::to_f(a.x[row + i]), y));
          a.x1[row + i] = Traits<T>::from_f(v);
        }
        xv[u] = v;
        ss = fmaf(v, v, ss);
      }
    }
    const float total = block_sum(ss, scratch);
    const float rinv = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(a.D)), a.eps));
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < a.D) {
        const float h = Traits<T>::round_trip(__fmul_rn(__fmul_rn(xv[u], rinv), scale[i]));
        for (int j = 0; j < n_proj; ++j)
          a.xq[static_cast<size_t>(j) * a.xq_stride + row + i] =
              Traits<T>::from_f(amvm::quant(h, rq[j], sq[j]));
      }
    }
  }
}

// Tile partials of up to three projections at layer l: projection projs[j]
// reads xq slot j and writes partial region j, (tile, B, N) row-major.
template <typename T>
__device__ void mvm_phase(const Args<T>& a, TileSmem& sm, int l, int n_proj,
                          const int* projs) {
  int count[3];
  int total = 0;
  for (int j = 0; j < n_proj; ++j) {
    int K, N;
    proj_kn(a, projs[j], K, N);
    count[j] = ((N + kCols - 1) / kCols) * n_tiles(a, projs[j]) *
               ((a.B + kRows - 1) / kRows);
    total += count[j];
  }
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    int j = 0, local = it;
    while (local >= count[j]) local -= count[j++];
    const int p = projs[j];
    int K, N;
    proj_kn(a, p, K, N);
    const int strips = (N + kCols - 1) / kCols;
    const int tiles = n_tiles(a, p);
    const int strip = local % strips;
    const int tile = (local / strips) % tiles;
    const int rb = local / (strips * tiles);
    const int span = a.span[p];
    const int t0 = tile * span;
    const int t1 = min(t0 + span, K);
    const T* w = a.w[p] + (p == kHead ? 0 : static_cast<size_t>(l) * K * N);
    const T* x = a.xq + static_cast<size_t>(j) * a.xq_stride;
    const float part = amvm::tile_partial<T>(sm, x, w, a.B, K, N, rb * kRows,
                                             strip * kCols, t0, t1, 0, 0.f, 1.f,
                                             a.vec_ok[p]);
    float r_a, step_a;
    amvm::quant_range(scalars(a, l, p)[0], a.bits[p], r_a, step_a);
    float q = amvm::quant(part, r_a, step_a);
    if (tiles > 1) q = Traits<T>::round_trip(q);
    const int m = rb * kRows + threadIdx.x / kCols;
    const int n = strip * kCols + threadIdx.x % kCols;
    if (m < a.B && n < N)
      a.part[static_cast<size_t>(j) * a.part_stride +
             (static_cast<size_t>(tile) * a.B + m) * N + n] = q;
  }
}

// rotate a head's row in place: [x1 c - x2 s, x2 c + x1 s], as models.rope
template <typename T>
__device__ __forceinline__ void rope_row(const Args<T>& a, float* v, int pos) {
  const int half = a.HD / 2;
  for (int d = threadIdx.x; d < half; d += kThreads) {
    const float ang = __fmul_rn(static_cast<float>(pos), a.freqs[d]);
    const float c = cosf(ang), s = sinf(ang);
    const float x1 = v[d], x2 = v[d + half];
    v[d] = Traits<T>::round_trip(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    v[d + half] = Traits<T>::round_trip(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
  }
}

template <typename T>
__device__ void attn_phase(const Args<T>& a, TileSmem& sm, float (*vec)[kMaxHd],
                           float* scratch, int l) {
  const int G = a.H / a.KV;
  const int HD = a.HD;
  const int qn = a.H * HD, kvn = a.KV * HD;
  float* sc = &sm.xs[0][0];  // scores, up to kRows * kChunk positions
  float* red = &sm.red[0][0][0];
  float r_o, step_o;
  dac_range(a, l, WO, r_o, step_o);
  for (int it = blockIdx.x; it < a.B * a.H; it += gridDim.x) {
    const int b = it / a.H, h = it % a.H, kvh = h / G;
    const int len = a.lens[b];
    const int idx = min(len, a.S - 1);
    const int nv = min(len + 1, a.S);
    float* qs = vec[0];
    float* ks = vec[1];
    float* vs = vec[2];
    for (int d = threadIdx.x; d < HD; d += kThreads) {
      qs[d] = combine(a, 0, WQ, l, qn, b, h * HD + d);
      ks[d] = combine(a, 1, WK, l, kvn, b, kvh * HD + d);
      vs[d] = combine(a, 2, WV, l, kvn, b, kvh * HD + d);
    }
    __syncthreads();
    rope_row(a, qs, len);
    rope_row(a, ks, len);
    __syncthreads();
    const size_t base = ((static_cast<size_t>(l) * a.B + b) * a.S) * kvn + kvh * HD;
    if (h % G == 0) {
      for (int d = threadIdx.x; d < HD; d += kThreads) {
        a.kc[base + static_cast<size_t>(idx) * kvn + d] = Traits<T>::from_f(ks[d]);
        a.vc[base + static_cast<size_t>(idx) * kvn + d] = Traits<T>::from_f(vs[d]);
      }
    }
    // scores: one warp per position, lanes across the head dim
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int pos = warp; pos < nv; pos += kWarps) {
      const T* krow = a.kc + base + static_cast<size_t>(pos) * kvn;
      float acc = 0.f;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(qs[d], pos == idx ? ks[d] : Traits<T>::to_f(krow[d]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sc[pos] = __fmul_rn(acc, a.attn_scale);
    }
    __syncthreads();
    float m = __int_as_float(0xff800000);  // -inf
    for (int pos = threadIdx.x; pos < nv; pos += kThreads) m = fmaxf(m, sc[pos]);
    m = block_max(m, scratch);
    float sum = 0.f;
    for (int pos = threadIdx.x; pos < nv; pos += kThreads) {
      const float e = expf(__fsub_rn(sc[pos], m));
      sc[pos] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = block_sum(sum, scratch);
    for (int pos = threadIdx.x; pos < nv; pos += kThreads)
      sc[pos] = Traits<T>::round_trip(__fdiv_rn(sc[pos], sum));  // p in T
    __syncthreads();
    // AV: groups of HD threads take interleaved positions
    const int groups = kThreads / HD;
    const int g = threadIdx.x / HD, d = threadIdx.x % HD;
    if (g < groups) {
      float acc = 0.f;
      for (int pos = g; pos < nv; pos += groups) {
        const float vv = pos == idx
            ? vs[d]
            : Traits<T>::to_f(a.vc[base + static_cast<size_t>(pos) * kvn + d]);
        acc = fmaf(sc[pos], vv, acc);
      }
      red[g * HD + d] = acc;
    }
    __syncthreads();
    if (threadIdx.x < HD) {
      float o = red[threadIdx.x];
      for (int gi = 1; gi < groups; ++gi) o = __fadd_rn(o, red[gi * HD + threadIdx.x]);
      o = Traits<T>::round_trip(o);
      a.xq[static_cast<size_t>(b) * qn + h * HD + threadIdx.x] =
          Traits<T>::from_f(amvm::quant(o, r_o, step_o));
    }
    __syncthreads();  // shared rows and scores are reused by the next item
  }
}

// silu(w1) * w3, then the DAC of w2, into xq slot 0 as (B, F)
template <typename T>
__device__ void gate_phase(const Args<T>& a, int l) {
  float r, step;
  dac_range(a, l, W2, r, step);
  const int n = a.B * a.F;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const int b = i / a.F, j = i % a.F;
    const float u = combine(a, 0, W1, l, a.F, b, j);
    const float g = combine(a, 1, W3, l, a.F, b, j);
    const float s = Traits<T>::round_trip(__fdiv_rn(u, __fadd_rn(1.f, expf(-u))));
    const float h = Traits<T>::round_trip(__fmul_rn(s, g));
    a.xq[i] = Traits<T>::from_f(amvm::quant(h, r, step));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) decode_fused_kernel(const Args<T> a) {
  __shared__ TileSmem sm;
  __shared__ float vec[3][kMaxHd];
  __shared__ float scratch[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int qkv[3] = {WQ, WK, WV};
  const int wo[1] = {WO};
  const int w13[2] = {W1, W3};
  const int w2[1] = {W2};
  const int head[1] = {kHead};
  int done = 0;
  // every block reaches every barrier, so all of them end at the same one
  auto sync = [&]() {
    grid.sync();
    return ++done == a.phases;
  };
  for (int l = 0; l < a.L; ++l) {
    row_phase(a, scratch, l, l == 0 ? 0 : 1, a.n1 + static_cast<size_t>(l) * a.D, 3, qkv, l);
    if (sync()) return;
    mvm_phase(a, sm, l, 3, qkv);
    if (sync()) return;
    attn_phase(a, sm, vec, scratch, l);
    if (sync()) return;
    mvm_phase(a, sm, l, 1, wo);
    if (sync()) return;
    row_phase(a, scratch, l, 2, a.n2 + static_cast<size_t>(l) * a.D, 2, w13, l);
    if (sync()) return;
    mvm_phase(a, sm, l, 2, w13);
    if (sync()) return;
    gate_phase(a, l);
    if (sync()) return;
    mvm_phase(a, sm, l, 1, w2);
    if (sync()) return;
  }
  row_phase(a, scratch, a.L, a.L == 0 ? 0 : 1, a.fin, 1, head, a.L);
  if (sync()) return;
  mvm_phase(a, sm, a.L, 1, head);
  if (sync()) return;
  const int n = a.B * a.V;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads)
    a.logits[i] = Traits<T>::from_f(combine(a, 0, kHead, a.L, a.V, i / a.V, i % a.V));
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < a.B; b += kThreads) a.lens_out[b] = a.lens[b] + 1;
}

template <typename T>
int launch(const void* const* ptrs, const int* ints, const float* flts, int grid,
           cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  a.h0 = static_cast<const T*>(ptrs[i++]);
  a.lens = static_cast<const int*>(ptrs[i++]);
  a.lens_out = static_cast<int*>(const_cast<void*>(ptrs[i++]));
  a.tab = static_cast<const float*>(ptrs[i++]);
  a.n1 = static_cast<const float*>(ptrs[i++]);
  a.n2 = static_cast<const float*>(ptrs[i++]);
  a.fin = static_cast<const float*>(ptrs[i++]);
  for (int p = 0; p < 8; ++p) a.w[p] = static_cast<const T*>(ptrs[i++]);
  a.kc = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  a.vc = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  a.freqs = static_cast<const float*>(ptrs[i++]);
  a.logits = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  a.x = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  a.x1 = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  a.xq = static_cast<T*>(const_cast<void*>(ptrs[i++]));
  a.part = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  int j = 0;
  a.L = ints[j++]; a.B = ints[j++]; a.D = ints[j++]; a.H = ints[j++];
  a.KV = ints[j++]; a.HD = ints[j++]; a.F = ints[j++]; a.V = ints[j++];
  a.S = ints[j++];
  for (int p = 0; p < 8; ++p) a.bits[p] = ints[j++];
  for (int p = 0; p < 8; ++p) a.span[p] = ints[j++];
  for (int p = 0; p < 8; ++p) a.vec_ok[p] = ints[j++];
  a.xq_stride = ints[j++];
  a.part_stride = ints[j++];
  a.phases = ints[j++];
  a.eps = flts[0];
  a.attn_scale = flts[1];
  if (grid < 1 || a.D > kThreads * 32 || a.HD > kMaxHd || a.HD % 2 ||
      a.KV < 1 || a.H % a.KV || a.S > kRows * amvm::kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  void* kargs[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decode_fused_kernel<T>), dim3(grid),
      dim3(kThreads), kargs, 0, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_blocks(int device) {
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_fused_kernel<T>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

}  // namespace

// ptrs: h0, lens, lens_out, tab, n1, n2, fin, the 7 stacks, lm_head, kc, vc,
// freqs, logits, x, x1, xq, part. ints: L, B, D, H, KV, HD, F, V, S, then
// bits, span and vec_ok of the 8 projections, xq_stride, part_stride,
// phases (0 = the whole step).
// flts: eps, attention scale. dtype: 0 = float32, 1 = bfloat16. Returns the
// launch's error code (0 = ok); a grid larger than the card holds at once
// is refused with cudaErrorCooperativeLaunchTooLarge.
extern "C" int decode_fused_launch(const void* const* ptrs, const int* ints,
                                   const float* flts, int dtype, int grid,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, ints, flts, grid, s);
  if (dtype == 1) return launch<__nv_bfloat16>(ptrs, ints, flts, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks the card holds at once (the cooperative grid limit), or minus the
// error code.
extern "C" int decode_fused_max_blocks(int dtype, int device) {
  if (dtype == 0) return max_blocks<float>(device);
  if (dtype == 1) return max_blocks<__nv_bfloat16>(device);
  return -static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
