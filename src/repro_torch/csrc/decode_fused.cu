// The whole programmed decode step of a dense LM in ONE launch, for Hopper
// (sm_90a): L x (RMSNorm -> wq/wk/wv -> RoPE -> K/V row write -> GQA decode
// attention -> wo + residual -> RMSNorm -> silu(w1) * w3 -> w2 + residual),
// then the final norm and the lm_head, for B slots.
//
// Replaces the TPU kernel src/repro/kernels/decode_fused.py::_decode_kernel
// (pallas_call at decode_fused.py:386). Its plain version is
// src/repro_torch/kernels/ref.py::decode_fused_ref. Each programmed MVM is
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
// Schedule. One cooperative launch of a persistent grid (one block of 256
// threads per SM); grid-wide barriers separate the dependent phases. Per
// layer:
//   1 row    residual add of the previous layer's w2 output, RMSNorm, the
//            DAC of wq/wk/wv (three quantized copies)
//   2 mvm    wq, wk, wv tile partials
//   3 attn   per (slot, KV head, pass of query heads): sum the q/k/v
//            partials, RoPE, write the K/V row (the first pass), scores,
//            softmax, the AV product, the DAC of wo
//   4 mvm    wo
//   5 row    residual add, RMSNorm, the DAC of w1 and w3
//   6 mvm    w1, w3
//   7 gate   silu(w1) * w3, the DAC of w2
//   8 mvm    w2
// then row (residual, final norm, DAC) -> mvm lm_head -> logits: 8 L + 2
// barriers per step. An MVM phase splits each projection into work items
// of (slots, output columns, one crossbar tile of K): the ADC acts on each
// tile's partial independently, so splitting K at tile boundaries is exact
// as long as the consumer sums the quantized partials in tile order, which
// every consumer does (`combine`; the workspace holds them as (tile, B, N)).
//
// Bound: at decode (B = 8) every weight is read once per step and used for
// 2 B flops per element: bytes over HBM bandwidth bound the step (2.07 GB
// of bf16 weights at tinyllama-1.1b: 0.62 ms at 3.35 TB/s). The design:
//
// * MVM items on the tensor cores in B1's exact per-element order. A bf16
//   projection that kernels/analog_mvm.py::tc_shape_ok takes runs the
//   tensor-core item (strip of 64 output columns x one crossbar tile x 16
//   slots); the host chooses per projection (`tc`), and fp32 and refused
//   shapes keep the CUDA-core item (analog_mvm_core.cuh::tile_partial, 32
//   columns x 8 slots, fp32 FMA). The tile's 128-row sub-chunks go 8 at a
//   time: warp w runs sub-chunk w through analog_mvm_tc_core.cuh's
//   sub_chain for all 64 columns (an fp32 mma.sync m16n8k16 chain from
//   zero per column group over the sub-chunk's real k16 steps, x rows 8-15
//   zero registers when B <= 8), the block adds the chains to each
//   output's fp32 tile sum in sub-chunk order from zero, and the ADC acts
//   at the tile's end: exactly the instructions B1's decode design
//   (analog_mvm_tc.cu) runs for each element, so each partial is bitwise
//   B1's on the same DAC codes. Eight independent chains a warp and one
//   barrier per 8 sub-chunks, where a warp per 8 columns of every
//   sub-chunk in turn paid a barrier and a dependent chain per 16 KB.
// * Weights in flight across phases and barriers. A block's tensor-core
//   stages (128 rows x 64 columns of one item's weights, 16 KB) form one
//   sequence over the whole step, known before it starts: the host deals
//   each MVM phase's items round-robin over the blocks and writes every
//   block's list once (kernels/decode_fused.py::item_table; decoding items
//   on the card stalled the producer at every item). Thread 0 keeps a
//   ring of `stages` (>= 8) of them in flight in dynamic shared memory,
//   one TMA copy each (a tensor map per projection, 128-byte swizzle read
//   back by ldmatrix; rows past K and columns past N arrive as zeros; an
//   mbarrier per slot counts the bytes; a bulk copy per 128-byte weight
//   row, 16 M copies a step, streamed far below the HBM rate), and refills
//   each slot the block consumes with its next stage, of this phase or a
//   later one. So a block leaves an MVM phase with the first stages of its
//   next one in flight, and HBM streams weights through the barriers and
//   the row, attention and gate phases. x (the DAC codes) depends on the
//   phase before: it is staged per item with cp.async after the barrier.
//   A launch that ends early (`phases`) waits for its copies in flight
//   before it returns.
// * Row phases on more blocks. Each (slot, column slice) is a block: it
//   computes the slot's whole residual and norm (the same bits in every
//   slice, loads before stores) and writes only its slice.
// * Attention: an item is (slot, KV head, pass of heads_per_pass query
//   heads), as many passes as give every block an item; the K and V rows
//   are read once per pass for all of its heads; scores take a thread per
//   position, AV a thread per (position group, head, 16 bytes of dims).
//   The cache does not depend on the step: each slot's old K and V rows of
//   the layer are pulled into L2 by one bulk prefetch a side, a phase
//   ahead (beside the qkv MVM), so attention's loads find them there.
// * Code size. The latency-bound phases run from a cold instruction cache
//   every layer, so less code is faster: each phase function has one call
//   site in the step loop (inlined at each use, the kernel held several
//   times the instructions), their loops over runtime bounds are not
//   unrolled, and an attention pass takes at most 2 query heads; every
//   extra unroll measured slower.
//
// The K/V row goes to min(length, S - 1), as the per-layer path clamps it;
// attention covers positions < min(length + 1, S) and takes the new row
// from shared memory.
//
// Inputs live on the device: the (L+1, 7, 3) f32 table of [r_adc, w_max,
// out_scale] with gain_s at [L, 1, 0], the slot lengths, the workspace
// (residual stream, DAC-quantized inputs, tile partials). Per-projection
// bitwidths, tile spans and item choices and the shared-memory layout
// (kernels/decode_fused.py::fused_layout) are launch arguments. The kernel
// allocates nothing and reads nothing back to the host.
//
// `phases` > 0 ends the launch at the barrier after that many phases (8 per
// layer in the order above, then the final row and the lm_head), with the
// workspace holding that phase's inputs and partials: the per-phase check
// (kernels/decode_fused_check.py) reads it there. 0 runs the whole step.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <dlfcn.h>

#include <type_traits>

#include "analog_mvm_core.cuh"
#include "analog_mvm_tc_core.cuh"
#include "decode_rows_core.cuh"

namespace cg = cooperative_groups;

namespace {

using amvm::kCols;
using amvm::kRows;
using amvm::kThreads;
using amvm::kWarps;
using amvm::TileSmem;
using amvm::Traits;
using amvm_tc::kSub;
using bf16 = __nv_bfloat16;

constexpr int kProj = 7;  // wq wk wv wo w1 w3 w2 per layer; index 7 = lm_head
constexpr int kMaxHd = 256;
constexpr int kHead = 7;
enum { WQ = 0, WK, WV, WO, W1, W3, W2 };

// the tensor-core item (kernels/decode_fused.py mirrors these)
constexpr int kStrip = 64;                       // output columns: 8 warps x 8
constexpr int kSlotBytes = kSub * kStrip * 2;    // one stage: a sub-chunk of K,
                                                 // 128-byte rows, swizzled
constexpr int kXPiece = 1024;                // x columns staged at once
constexpr int kXRow = kXPiece * 2 + 16;      // bytes of a staged x row, padded
constexpr int kMaxStages = 16;
using drows::kMaxPass;  // attention: query heads per pass

template <typename T>
struct Args {
  CUtensorMap maps[8];  // tensor-core projections' weights: (N, K, L) in
                        // boxes of 64 x 128 x 1, 128-byte swizzle
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
  int tc[8];            // 1: projection p runs the tensor-core item
  int stages;           // weight ring stages (0: no tensor-core projection)
  int x_rows;           // rows of staged x: 8, or 16 when B > 8
  int heads_per_pass;   // attention: query heads per pass (<= kMaxPass)
  int row_slices;       // row phases: blocks per slot
  int smem_x, smem_work, smem_bytes;  // dynamic shared memory: ring at 0
  const int4* items;    // (grid, items_per_block) each block's MVM items
  int items_per_block;  // (kernels/decode_fused.py::item_table)
  float eps, attn_scale;
};

// A block's MVM items and weight stream. Every thread holds the consumers'
// place in the block's item list and counts the stages consumed; thread 0,
// the producer, holds its own place (the item whose stages it copies next,
// the row after it loaded ahead) and counts the stages started.
struct Pipe {
  uint32_t ring, bars;  // shared addresses of slot 0 and of its mbarrier
  int stages;
  int prod, cons;
  const int4* list;     // the block's rows of the item table
  int ci;               // consumers: the next row to run
  int4 crow;            // ... loaded ahead
  int pi, sub;          // producer: its row and the sub-chunk it copies next
  int4 prow, pnext;     // ... that row and the one after it
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a TMA map (at column c0, row c1, layer c2) into shared memory;
// completion counted on the mbarrier (elements past the tensor are zeros)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- helpers

// (K, N) of projection p; the launcher also reads it on the host
template <typename T>
__host__ __device__ __forceinline__ void proj_kn(const Args<T>& a, int p, int& K, int& N) {
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
  constexpr int kLoads = 4;  // tiles whose loads are in flight together
  const float* pr = a.part + static_cast<size_t>(region) * a.part_stride +
                    static_cast<size_t>(m) * N + n;
  const int tiles = n_tiles(a, p);
  const size_t plane = static_cast<size_t>(a.B) * N;
  float y = 0.f;
  #pragma unroll 1
  for (int t0 = 0; t0 < tiles; t0 += kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = t0 + u < tiles ? pr[(t0 + u) * plane] : 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (t0 + u < tiles) y = t0 + u == 0 ? v[u] : __fadd_rn(y, v[u]);
  }
  return Traits<T>::round_trip(__fmul_rn(y, scalars(a, l, p)[2]));
}

// ---------------------------------------------------------------- work items

struct Item {
  int j;       // the projection's place in its phase: xq slot, partial region
  int p;       // projection
  int tc;      // runs the tensor-core item
  int tile;    // crossbar tile of K: rows [t0, t1)
  int t0, t1;
  int n0, m0;  // first output column, first slot
};

__device__ __forceinline__ int row_phase_of(int4 r) { return r.w & 0xFFFF; }
constexpr int kEnd = 0xFFFF;  // the MVM phase of a list's last row

// a row of the item table: [n0, t0, p | j << 3 | tc << 5 | slot block << 6,
// mp | tile << 16]
template <typename T>
__device__ __forceinline__ Item decode(const Args<T>& a, int4 r) {
  Item x;
  x.n0 = r.x;
  x.t0 = r.y;
  x.p = r.z & 7;
  x.j = (r.z >> 3) & 3;
  x.tc = (r.z >> 5) & 1;
  x.m0 = (r.z >> 6) * (x.tc ? 16 : kRows);
  x.tile = r.w >> 16;
  int K, N;
  proj_kn(a, x.p, K, N);
  x.t1 = min(x.t0 + a.span[x.p], K);
  return x;
}

__device__ __forceinline__ int sub_count(const Item& x) {
  return (x.t1 - x.t0 + kSub - 1) / kSub;
}

// ---------------------------------------------------------------- the weight ring

// thread 0: step to the next row of the list (loading the one after it
// ahead), then past rows that are not tensor-core items
__device__ __forceinline__ void next_row(Pipe& pp) {
  do {
    pp.prow = pp.pnext;
    ++pp.pi;
    if (row_phase_of(pp.prow) != kEnd) pp.pnext = __ldg(pp.list + pp.pi + 1);
  } while (row_phase_of(pp.prow) != kEnd && !((pp.prow.z >> 5) & 1));
}

// thread 0 copies its next stage (128 rows of K x the item's 64 columns;
// rows past K and columns past N arrive as zeros) into slot prod % stages:
// one TMA copy
template <typename T>
__device__ __forceinline__ void fetch_stage(const Args<T>& a, Pipe& pp) {
  const Item x = decode(a, pp.prow);
  const int mp = row_phase_of(pp.prow);
  const int slot = pp.prod % pp.stages;
  const uint32_t bar = pp.bars + slot * 8;
  mbar_expect_tx(bar, kSlotBytes);
  tma_load_3d(pp.ring + slot * kSlotBytes, &a.maps[x.p], x.n0, x.t0 + pp.sub * kSub,
              mp < 4 * a.L ? mp >> 2 : 0, bar);
  ++pp.prod;
  if (++pp.sub == sub_count(x)) {
    pp.sub = 0;
    next_row(pp);
  }
}

// thread 0 keeps `stages` stages in flight
template <typename T>
__device__ __forceinline__ void fill(const Args<T>& a, Pipe& pp) {
  if (threadIdx.x != 0) return;
  while (pp.prod - pp.cons < pp.stages && row_phase_of(pp.prow) != kEnd) fetch_stage(a, pp);
}

// thread 0 waits for every copy started and not consumed (before an early
// return: the block's shared memory outlives none of them)
__device__ void drain(const Pipe& pp) {
  if (threadIdx.x != 0) return;
  for (int s = pp.cons; s < pp.prod; ++s)
    mbar_wait(pp.bars + (s % pp.stages) * 8, (s / pp.stages) & 1);
}

// ---------------------------------------------------------------- MVM items

// The tensor-core item: B1's decode-design arithmetic per element (see the
// header), its tile partial through the ADC to part[j][tile][m][n]. The
// tile's sub-chunks go in groups of up to 8 (one staged piece of x): warp w
// runs sub-chunk w of the group for all 64 columns (eight independent mma
// chains), writes its chains to `red`, and after one barrier every thread
// adds the group's chains to its outputs' tile sums in sub-chunk order.
__device__ void tc_item(const Args<bf16>& a, Pipe& pp, const Item& x, int layer,
                        uint32_t xs, float* red) {
  using amvm_tc::ldsm_x2;
  using amvm_tc::ldsm_x4;
  using amvm_tc::ldsm_x4_t;
  constexpr int kOut = 16 * kStrip / kThreads;  // tile sums a thread holds (16 rows)
  int K, N;
  proj_kn(a, x.p, K, N);
  const bf16* xg = a.xq + static_cast<size_t>(x.j) * a.xq_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int outs = a.x_rows * kStrip;  // (row, column) outputs of the item
  float tile[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) tile[k] = 0.f;
  for (int kp = x.t0; kp < x.t1; kp += kXPiece) {
    const int kp1 = min(kp + kXPiece, x.t1);
    const int subs = (kp1 - kp + kSub - 1) / kSub;  // sub-chunks of the piece, <= 8
    __syncthreads();  // every warp is done with the previous piece of x and red
    // x rows m0.. (rows past B zero), columns [kp, kp1) (past kp1 zero)
    for (int i = threadIdx.x; i < a.x_rows * (kXPiece / 8); i += kThreads) {
      const int r = i / (kXPiece / 8), ch = i % (kXPiece / 8);
      const int m = x.m0 + r, k = kp + ch * 8;
      const bool ok = m < a.B && k < kp1;
      amvm_tc::cp_async16(xs + r * kXRow + ch * 16,
                          xg + (ok ? static_cast<size_t>(m) * K + k : 0), ok);
    }
    amvm_tc::cp_async_commit();
    amvm_tc::cp_async_wait<0>();
    __syncthreads();
    if (warp < subs) {
      const int s = pp.cons + warp;  // this warp's stage
      mbar_wait(pp.bars + s % pp.stages * 8, s / pp.stages & 1);
      const uint32_t ws = pp.ring + s % pp.stages * kSlotBytes;
      const int c0 = kp + warp * kSub;
      const int xc = warp * (kSub / 8);  // the sub-chunk's first 16-byte chunk of x
      float acc[8][4];
      amvm_tc::sub_chain<8>(
          acc, (min(c0 + kSub, kp1) - c0 + 15) / 16,
          [&](int kk, uint32_t (&af)[4]) {
            if (a.x_rows == 16) {
              ldsm_x4(xs + (lane & 15) * kXRow + (xc + kk * 2 + (lane >> 4)) * 16, af);
            } else {  // rows 8-15 of the mma tile: zero registers
              uint32_t lo[2];
              ldsm_x2(xs + (lane & 7) * kXRow + (xc + kk * 2 + ((lane >> 3) & 1)) * 16, lo);
              af[0] = lo[0];
              af[1] = 0u;
              af[2] = lo[1];
              af[3] = 0u;
            }
          },
          [&](int kk, uint32_t (&bf)[16]) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // column groups 2q and 2q + 1
              uint32_t r4[4];
              ldsm_x4_t(ws + amvm_tc::swz(kk * 16 + (lane & 15), 2 * q + (lane >> 4)) * 16, r4);
#pragma unroll
              for (int e = 0; e < 4; ++e) bf[4 * q + e] = r4[e];
            }
          });
      // C fragment: e = 0, 1 at row lane / 4, e = 2, 3 eight rows below;
      // columns 8 g + 2 (lane % 4) + (e & 1)
      float* r = red + warp * outs;
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (lane >> 2) + h * 8;
          if (m < a.x_rows) {
            r[m * kStrip + 8 * g + (lane & 3) * 2] = acc[g][2 * h];
            r[m * kStrip + 8 * g + (lane & 3) * 2 + 1] = acc[g][2 * h + 1];
          }
        }
    }
    __syncthreads();  // the group's chains are in red; its slots are read
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int o = threadIdx.x + k * kThreads;
      if (o < outs)
        for (int w = 0; w < subs; ++w) tile[k] = __fadd_rn(tile[k], red[w * outs + o]);
    }
    pp.cons += subs;
    fill(a, pp);
  }
  const amvm_tc::Adc adc = amvm_tc::make_adc(nullptr, nullptr, scalars(a, layer, x.p)[0], 1.f,
                                             a.bits[x.p], n_tiles(a, x.p) > 1);
  float* part = a.part + static_cast<size_t>(x.j) * a.part_stride +
                static_cast<size_t>(x.tile) * a.B * N;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int o = threadIdx.x + k * kThreads;
    const int m = x.m0 + o / kStrip, n = x.n0 + o % kStrip;
    if (o < outs && m < a.B && n < N) part[static_cast<size_t>(m) * N + n] = adc.partial(tile[k]);
  }
}

// The CUDA-core item: (8 slots, 32 columns, one crossbar tile), fp32 FMA
// (analog_mvm_core.cuh::tile_partial), then the ADC.
template <typename T>
__device__ void cc_item(const Args<T>& a, TileSmem& sm, const Item& x, int layer) {
  int K, N;
  proj_kn(a, x.p, K, N);
  const T* w = a.w[x.p] + (x.p == kHead ? 0 : static_cast<size_t>(layer) * K * N);
  const T* xg = a.xq + static_cast<size_t>(x.j) * a.xq_stride;
  const float part = amvm::tile_partial<T>(sm, xg, w, a.B, K, N, x.m0, x.n0, x.t0, x.t1, 0,
                                           0.f, 1.f, a.vec_ok[x.p]);
  float r_a, step_a;
  amvm::quant_range(scalars(a, layer, x.p)[0], a.bits[x.p], r_a, step_a);
  float q = amvm::quant(part, r_a, step_a);
  if (n_tiles(a, x.p) > 1) q = Traits<T>::round_trip(q);
  const int m = x.m0 + threadIdx.x / kCols;
  const int n = x.n0 + threadIdx.x % kCols;
  if (m < a.B && n < N)
    a.part[static_cast<size_t>(x.j) * a.part_stride +
           (static_cast<size_t>(x.tile) * a.B + m) * N + n] = q;
}

// Tile partials of MVM phase mp (4 per layer -- qkv, wo, w13, w2 -- then
// the lm_head), the block's items of it in list order: projection j of
// the phase reads xq slot j and writes partial region j, (tile, B, N)
// row-major.
template <typename T>
__device__ void mvm_phase(const Args<T>& a, Pipe& pp, unsigned char* dsm, int mp) {
  const int layer = mp < 4 * a.L ? mp >> 2 : a.L;
  while (row_phase_of(pp.crow) == mp) {
    const Item x = decode(a, pp.crow);
    pp.crow = __ldg(pp.list + ++pp.ci);  // the next row, loaded while this one runs
    if constexpr (std::is_same<T, bf16>::value) {
      if (x.tc) {
        tc_item(a, pp, x, layer, amvm_tc::smem_u32(dsm + a.smem_x),
                reinterpret_cast<float*>(dsm + a.smem_work));
        continue;
      }
    }
    cc_item(a, *reinterpret_cast<TileSmem*>(dsm + a.smem_work), x, layer);
  }
}

// ---------------------------------------------------------------- other phases

// Per (slot, column slice): finish the slot's residual, RMSNorm with
// `scale`, and write the slice of the residual and of the DAC-quantized
// input of each projection in `projs` (row-major (B, D)) to the xq slots
// 0.. . Every slice of a slot computes the whole row, in the same order.
// `from` says where the residual comes from: 0 = the embedded tokens
// (layer 0), 1 = x1 + w2 output of layer l - 1 (into x), 2 = x + wo output
// of layer l (into x1).
template <typename T>
__device__ void row_phase(const Args<T>& a, float* scratch, float* xv, int l, int from,
                          const float* scale, int n_proj, const int* projs,
                          int dac_layer) {
  float rq[3], sq[3];
  for (int j = 0; j < n_proj; ++j) dac_range(a, dac_layer, projs[j], rq[j], sq[j]);
  const int width = (a.D + a.row_slices - 1) / a.row_slices;
  for (int it = blockIdx.x; it < a.B * a.row_slices; it += gridDim.x) {
    const int b = it / a.row_slices;
    const int lo = it % a.row_slices * width, hi = min(lo + width, a.D);
    const size_t row = static_cast<size_t>(b) * a.D;
    // the norm's statistics in decode_rows_core.cuh's order (its barrier
    // also publishes xv)
    const float rinv = drows::norm_stats(
        [&](int i) {
          if (from == 0) return Traits<T>::to_f(a.h0[row + i]);
          const float y = from == 1 ? combine(a, 0, W2, l - 1, a.D, b, i)
                                    : combine(a, 0, WO, l, a.D, b, i);
          const T* res = from == 1 ? a.x1 : a.x;
          return Traits<T>::round_trip(__fadd_rn(Traits<T>::to_f(res[row + i]), y));
        },
        xv, a.D, a.eps, scratch);
    T* res = from == 2 ? a.x1 : a.x;
    #pragma unroll 1
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      res[row + i] = Traits<T>::from_f(xv[i]);
      const float h = drows::normed<T>(xv[i], rinv, scale[i]);
      for (int j = 0; j < n_proj; ++j)
        a.xq[static_cast<size_t>(j) * a.xq_stride + row + i] =
            Traits<T>::from_f(amvm::quant(h, rq[j], sq[j]));
    }
    __syncthreads();  // xv is rewritten by the next item
  }
}

// Per (slot, KV head, pass of heads_per_pass query heads): the KV head's
// new K/V row (written by the first pass's item), then the pass's heads.
// work holds the pass's q rows (hp x HD), scores (hp x S) and the AV
// product's per-group sums (kThreads x V).
template <typename T>
__device__ void attn_phase(const Args<T>& a, float (*vec)[kMaxHd], float* work, int l) {
  constexpr int V = Traits<T>::kVec;
  const int G = a.H / a.KV, HD = a.HD, hp = a.heads_per_pass;
  const int qn = a.H * HD, kvn = a.KV * HD;
  const bool vec_kv = HD % V == 0 && kvn % V == 0;  // 16-byte K row loads
  float* qs = work;
  float* sc = qs + hp * HD;
  float* red = sc + hp * a.S;  // AV sums per position group: <= kThreads x V
  float* ks = vec[0];
  float* vs = vec[1];
  float r_o, step_o;
  dac_range(a, l, WO, r_o, step_o);
  const int passes = (G + hp - 1) / hp;
  for (int it = blockIdx.x; it < a.B * a.KV * passes; it += gridDim.x) {
    const int b = it / (a.KV * passes), kvh = it / passes % a.KV, h0 = it % passes * hp;
    const int len = a.lens[b];
    const int idx = min(len, a.S - 1);
    const int nv = min(len + 1, a.S);
    const int nh = min(hp, G - h0);
    const int q0 = (kvh * G + h0) * HD;  // the item's first column of q
    // the k, v and q rows from their partials, every load in one round
    #pragma unroll 1
    for (int i = threadIdx.x; i < (2 + nh) * HD; i += kThreads) {
      if (i < HD)
        ks[i] = combine(a, 1, WK, l, kvn, b, kvh * HD + i);
      else if (i < 2 * HD)
        vs[i - HD] = combine(a, 2, WV, l, kvn, b, kvh * HD + i - HD);
      else
        qs[i - 2 * HD] = combine(a, 0, WQ, l, qn, b, q0 + i - 2 * HD);
    }
    __syncthreads();
    drows::rope_rows<T>(ks, 1, len, HD, a.freqs);
    drows::rope_rows<T>(qs, nh, len, HD, a.freqs);
    __syncthreads();
    const size_t base = ((static_cast<size_t>(l) * a.B + b) * a.S) * kvn + kvh * HD;
    if (h0 == 0) {  // the first pass's item writes the KV head's new row
      for (int d = threadIdx.x; d < HD; d += kThreads) {
        a.kc[base + static_cast<size_t>(idx) * kvn + d] = Traits<T>::from_f(ks[d]);
        a.vc[base + static_cast<size_t>(idx) * kvn + d] = Traits<T>::from_f(vs[d]);
      }
    }
    // scores, softmax and the AV product (decode_rows_core.cuh), then the
    // DAC of wo; attend's closing barrier frees the q rows, scores and sums
    // for the next pass
    drows::attend<T>(a.kc + base, a.vc + base, kvn, HD, a.S, nv, idx, vec_kv, ks, vs, qs, nh,
                     sc, red, a.attn_scale, [&](int i, float o) {
                       a.xq[static_cast<size_t>(b) * qn + q0 + i] =
                           Traits<T>::from_f(amvm::quant(o, r_o, step_o));
                     });
  }
}

// thread 0 of block b < B: start pulling slot b's K and V rows of layer l
// that attention will read (the positions before its new row) into L2,
// one bulk prefetch per side; the cache does not depend on the step, so
// this runs a phase ahead, beside the qkv MVM
template <typename T>
__device__ __forceinline__ void prefetch_kv(const Args<T>& a, int l) {
  const int b = blockIdx.x;
  if (threadIdx.x != 0 || b >= a.B) return;
  const int kvn = a.KV * a.HD, n = min(a.lens[b], a.S - 1);
  const size_t base = (static_cast<size_t>(l) * a.B + b) * a.S * kvn;
  const uint32_t bytes = static_cast<uint32_t>(n) * kvn * sizeof(T) / 16 * 16;
  if (bytes == 0) return;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(a.kc + base), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(a.vc + base), "r"(bytes)
               : "memory");
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
    a.xq[i] = Traits<T>::from_f(amvm::quant(drows::gate<T>(u, g), r, step));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    decode_fused_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  __shared__ float vec[2][kMaxHd];
  __shared__ float scratch[kWarps];
  cg::grid_group grid = cg::this_grid();
  // the ring at the first 1024-byte boundary (the 128-byte swizzle's unit)
  Pipe pp;
  pp.ring = (amvm_tc::smem_u32(dsm) + 1023u) & ~1023u;
  pp.bars = amvm_tc::smem_u32(bars);
  pp.stages = a.stages;
  pp.prod = pp.cons = 0;
  pp.list = a.items + static_cast<size_t>(blockIdx.x) * a.items_per_block;
  pp.ci = 0;
  pp.crow = __ldg(pp.list);
  if (a.stages > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < a.stages; ++s) mbar_init(pp.bars + s * 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      pp.pi = -1;
      pp.sub = 0;
      pp.pnext = pp.crow;
      pp.prow = make_int4(0, 0, 0, 0);  // not the end: next_row loads row 0
      next_row(pp);
    }
    __syncthreads();
    fill(a, pp);
  }
  float* work = reinterpret_cast<float*>(dsm + a.smem_work);
  const int qkv[3] = {WQ, WK, WV};
  const int w13[2] = {W1, W3};
  const int head[1] = {kHead};
  // Phase ph of the step: 8 per layer (row, mvm qkv, attn, mvm wo, row,
  // mvm w13, gate, mvm w2), then the final row and the lm_head; one call
  // site per phase function (see the header). Every block reaches every
  // barrier, so all of them end at the same one.
  for (int ph = 0; ph < 8 * a.L + 2; ++ph) {
    const int l = ph / 8, k = ph % 8;
    if (k == 0 || (k == 4 && l < a.L)) {
      const bool first = k == 0;
      const float* scale = l == a.L ? a.fin
                                    : (first ? a.n1 : a.n2) + static_cast<size_t>(l) * a.D;
      row_phase(a, scratch, work, l, first ? (l == 0 ? 0 : 1) : 2, scale,
                l == a.L ? 1 : (first ? 3 : 2), l == a.L ? head : (first ? qkv : w13), l);
    } else if (k % 2 == 1) {
      if (k == 1 && l < a.L) prefetch_kv(a, l);
      mvm_phase(a, pp, dsm, 4 * l + k / 2);
    } else if (k == 2) {
      attn_phase(a, vec, work, l);
    } else {
      gate_phase(a, l);
    }
    grid.sync();
    if (ph + 1 == a.phases) {
      drain(pp);
      return;
    }
  }
  const int n = a.B * a.V;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads)
    a.logits[i] = Traits<T>::from_f(combine(a, 0, kHead, a.L, a.V, i / a.V, i % a.V));
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < a.B; b += kThreads) a.lens_out[b] = a.lens[b] + 1;
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (no -lcuda at build time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// bf16 weights (layers, K, N) as a TMA map of 64-column x 128-row boxes,
// 128-byte swizzle: chunk c of box row r lands at (c ^ (r & 7)), as
// amvm_tc::swz reads it
bool encode_weights(CUtensorMap* map, const void* w, int N, int K, int layers) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(layers)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(N) * K * 2};
  const cuuint32_t box[3] = {kStrip, kSub, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// allow `bytes` of dynamic shared memory (above 48 KB only when asked)
template <typename T>
cudaError_t allow_smem(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      decode_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
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
  a.items = static_cast<const int4*>(ptrs[i++]);
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
  bool any_tc = false;
  for (int p = 0; p < 8; ++p) any_tc |= (a.tc[p] = ints[j++]) != 0;
  a.stages = ints[j++];
  a.x_rows = ints[j++];
  a.heads_per_pass = ints[j++];
  a.row_slices = ints[j++];
  a.smem_x = ints[j++];
  a.smem_work = ints[j++];
  a.smem_bytes = ints[j++];
  a.items_per_block = ints[j++];
  a.eps = flts[0];
  a.attn_scale = flts[1];
  if (grid < 1 || a.D > kThreads * 32 || a.HD > kMaxHd || a.HD % 2 || a.KV < 1 ||
      a.H % a.KV || a.heads_per_pass < 1 || a.heads_per_pass > kMaxPass ||
      a.row_slices < 1 || a.stages < 0 || a.stages > kMaxStages || a.items_per_block < 1 ||
      (any_tc && (!std::is_same<T, bf16>::value || a.stages < kXPiece / kSub ||
                  (a.x_rows != 8 && a.x_rows != 16) || (a.x_rows == 8 && a.B > 8))) ||
      a.smem_x % 16 || a.smem_work % 16 || a.smem_x < a.stages * kSlotBytes + (any_tc ? 1024 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same<T, bf16>::value) {
    for (int p = 0; p < 8; ++p) {
      if (!a.tc[p]) continue;
      int K, N;
      proj_kn(a, p, K, N);
      if (!encode_weights(&a.maps[p], a.w[p], N, K, p == kHead ? 1 : a.L))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t e = allow_smem<T>(a.smem_bytes);
  if (e == cudaSuccess) {
    void* kargs[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_fused_kernel<T>),
                                    dim3(grid), dim3(kThreads), kargs, a.smem_bytes, stream);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_blocks(int device, int smem_bytes) {
  int per_sm = 0, sms = 0;
  cudaError_t e = allow_smem<T>(smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_fused_kernel<T>,
                                                      kThreads, smem_bytes);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

}  // namespace

// ptrs: h0, lens, lens_out, tab, n1, n2, fin, the 7 stacks, lm_head, kc, vc,
// freqs, logits, x, x1, xq, part, the item table. ints: L, B, D, H, KV, HD, F, V, S, then
// bits, span and vec_ok of the 8 projections, xq_stride, part_stride,
// phases (0 = the whole step), then tc of the 8 projections, stages,
// x_rows, heads_per_pass, row_slices, the dynamic shared-memory offsets of
// staged x and of the work area and its total bytes
// (kernels/decode_fused.py::fused_layout), and the item table's rows per
// block (kernels/decode_fused.py::item_table).
// flts: eps, attention scale. dtype: 0 = float32, 1 = bfloat16. Returns the
// launch's error code (0 = ok); a grid larger than the card holds at once
// is refused with cudaErrorCooperativeLaunchTooLarge.
extern "C" int decode_fused_launch(const void* const* ptrs, const int* ints,
                                   const float* flts, int dtype, int grid,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, ints, flts, grid, s);
  if (dtype == 1) return launch<bf16>(ptrs, ints, flts, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks the card holds at once with `smem_bytes` of dynamic shared memory
// each (the cooperative grid limit), or minus the error code.
extern "C" int decode_fused_max_blocks(int dtype, int device, int smem_bytes) {
  if (dtype == 0) return max_blocks<float>(device, smem_bytes);
  if (dtype == 1) return max_blocks<bf16>(device, smem_bytes);
  return -static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
