// Device code of the tensor-core programmed MVM shared by B1's decode and
// prefill designs (analog_mvm_tc.cu) and B2's tensor-core MVM item
// (decode_fused.cu), so every one of them performs the same per-element
// arithmetic: the PTX helpers (cp.async, ldmatrix, mma.sync), the XOR
// swizzle of staged tiles with 128-byte rows, the ADC epilogue of one
// output element, and the fp32 chain of one 128-row sub-chunk.
//
// The order, per output element (analog_mvm_tc.cu's header has the why):
//   s_c = the mma.sync m16n8k16 products of sub-chunk c's k16 steps, in
//         order, accumulated in fp32 from zero (only steps that hold a real
//         row of K)                                        -- sub_chain
//   p_t = ((0 + s_c0) + s_c1) + ...  (crossbar tile t's sub-chunks in order)
//   q_t = quant(p_t), rounded to bf16 when K spans several tiles -- Adc
//         (the training form: quant(p_t) where its keep mask is set, else
//         p_t -- Adc::tile_q_keep, finish_keep)
//   y   = ((q_0 + q_1) + ...) * out_scale, rounded to bf16

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "analog_mvm_core.cuh"

namespace amvm_tc {

constexpr int kSub = 128;  // K rows per sub-chunk (one fp32 mma chain)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; a false predicate writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows of 8 16-byte chunks; chunk c of row r at (c ^ (r & 7)): the 8 rows
// an ldmatrix reads at one column land in 8 different bank groups
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 8 + (chunk ^ (row & 7));
}

// the ADC epilogue of one output element
struct Adc {
  float r, step, out_scale;
  int multi;  // K spans several crossbar tiles: each tile's q rounds to bf16
  __device__ __forceinline__ float tile_q(float tile) const {
    return amvm::Traits<__nv_bfloat16>::round_trip(amvm::quant(tile, r, step));
  }
  // what one crossbar tile contributes to the tile-serial sum
  __device__ __forceinline__ float partial(float tile) const {
    return multi ? tile_q(tile) : amvm::quant(tile, r, step);
  }
  __device__ __forceinline__ float finish(float y, float tile) const {
    return __fmul_rn(multi ? y : amvm::quant(tile, r, step), out_scale);
  }
  // The training form (B1's prefill design with a quant-noise keep mask):
  // the ADC where the mask is set, the unquantized value where it is not
  // (src/repro/core/engine.py:219-246). With q set these are tile_q and
  // finish, so an all-ones mask gives the serving bits; the serving
  // epilogues above are not touched.
  __device__ __forceinline__ float tile_q_keep(float tile, bool q) const {
    return amvm::Traits<__nv_bfloat16>::round_trip(q ? amvm::quant(tile, r, step) : tile);
  }
  __device__ __forceinline__ float finish_keep(float y, float tile, bool q) const {
    return __fmul_rn(multi ? y : (q ? amvm::quant(tile, r, step) : tile), out_scale);
  }
};

__device__ __forceinline__ Adc make_adc(const float* r_adc_p, const float* out_scale_p,
                                        float r_adc_h, float out_scale_h, int b_adc,
                                        int multi) {
  Adc a;
  amvm::quant_range(r_adc_p ? *r_adc_p : r_adc_h, b_adc, a.r, a.step);
  a.out_scale = out_scale_p ? *out_scale_p : out_scale_h;
  a.multi = multi;
  return a;
}

// One sub-chunk's chain for NG 8-column groups that share the A fragment:
// acc[g] from zero, then acc[g] += a_kk * b_kk[g] by one mma.sync per k16
// step kk < steps (the steps holding a real row of K), in order.
// load_a(kk, a) fills the A fragment of step kk (16 x 16; rows past M
// zero), load_b(kk, b) the B fragments (b[2g], b[2g + 1] of group g).
template <int NG, typename LoadA, typename LoadB>
__device__ __forceinline__ void sub_chain(float (&acc)[NG][4], int steps, LoadA load_a,
                                          LoadB load_b) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSub / 16; ++kk) {
    if (kk >= steps) break;
    uint32_t a[4], b[2 * NG];
    load_a(kk, a);
    load_b(kk, b);
#pragma unroll
    for (int g = 0; g < NG; ++g) mma_bf16(acc[g], a, b[2 * g], b[2 * g + 1]);
  }
}

}  // namespace amvm_tc
