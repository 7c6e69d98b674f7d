// Device code shared by the programmed-MVM kernels (analog_mvm.cu and
// decode_fused.cu), so both quantize identically: the element traits of
// float and bfloat16, the hard symmetric fake-quantizer, the 16-byte weight
// load, and the fp32 partial of one crossbar tile for a 256-thread block
// that owns 8 rows of x and 32 output columns.
//
// tile_partial computes, for the (row, column) a thread owns in the
// epilogue (row tid / 32, column tid % 32 of the block's strip),
//
//     part = sum_{k in [t0, t1)} x[m0 + row, k] * w[k, n0 + col]
//
// in fp32 FMA: lanes split the strip's columns into 16-byte vectors and K
// within a warp, warps split K; the lanes sharing a column are summed by a
// fixed xor butterfly, then the warps in fixed order. x is staged through
// shared memory 1024 rows of K at a time (optionally DAC fake-quantized as
// it is staged); rows past M stage as zeros. The caller applies the ADC.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace amvm {

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

// r = |range| + 1e-9 and step = r / (2^(bits-1) - 1), as core/quant.py's
// fake_quant derives them
__device__ __forceinline__ void quant_range(float range, int bits, float& r,
                                            float& step) {
  r = __fadd_rn(fabsf(range), 1e-9f);
  step = __fdiv_rn(r, static_cast<float>((1 << (bits - 1)) - 1));
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

struct TileSmem {
  float xs[kRows][kChunk];
  float red[kWarps][kRows][kCols];
};

// The fp32 partial over rows [t0, t1) of K (see the header comment). Every
// thread of the block calls it; it begins with a block barrier, so the
// caller may still be reading sm.red from the previous call.
template <typename T>
__device__ float tile_partial(TileSmem& sm, const T* __restrict__ x,
                              const T* __restrict__ w, int M, int K, int N,
                              int m0, int n0, int t0, int t1, int apply_dac,
                              float r_d, float step_d, int vec_ok) {
  constexpr int V = Traits<T>::kVec;
  constexpr int CL = kCols / V;       // lanes across the block's columns
  constexpr int KL = 32 / CL;         // lanes across K within a warp
  constexpr int KSTEP = kWarps * KL;  // K rows the block covers per step

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cl = lane % CL;
  const int kl = lane / CL;
  const int ncol = n0 + cl * V;
  const int kidx = warp * KL + kl;

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
      sm.xs[r][kk] = v;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = kidx; kk < clen; kk += KSTEP) {
      float wv[V];
      load_w<T>(w, c0 + kk, N, ncol, vec_ok, wv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = sm.xs[r][kk];
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
      for (int v = 0; v < V; ++v) sm.red[warp][r][cl * V + v] = acc[r][v];
  }
  __syncthreads();
  const int orow = tid / kCols;
  const int ocol = tid % kCols;
  float part = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) part = __fadd_rn(part, sm.red[wi][orow][ocol]);
  return part;
}

}  // namespace amvm
