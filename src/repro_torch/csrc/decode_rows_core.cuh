// Per-element code of the decode step outside the programmed MVMs, shared
// by the fused decode kernel (decode_fused.cu, B2) and the per-layer
// decode's row kernels (decode_rows.cu): RMSNorm with its reduction order,
// RoPE, the decode-attention pass over (slot, KV head, pass of query
// heads), and the silu gate. Both kernels run these functions, so a
// per-layer decode step on the card computes every norm, rotated row,
// attention output and gate product with the same instructions as the
// fused step, and feeds the same DAC codes and K/V rows to the next MVM
// and the cache (B1 and B2 share analog_mvm_tc_core.cuh the same way).
//
// Every rounding is explicit (_rn intrinsics, fmaf where a product and a
// sum fuse), so the compiler cannot contract an expression differently in
// the two kernels. Rounding to the activation dtype T happens where the
// per-layer PyTorch path rounds: after the norm, RoPE, the softmax
// probabilities, the attention output, silu and the gate product.

#pragma once

#include "analog_mvm_core.cuh"

namespace drows {

using amvm::kThreads;
using amvm::kWarps;
using amvm::Traits;

constexpr int kBatch = 2;    // norm: elements a thread loads before it uses them
constexpr int kMaxPass = 2;  // attention: query heads per pass (a register accumulator each)

// the block's sum of v: warp shuffles, then the warps' sums in warp order
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

// RMSNorm statistics of one row of D values: load(i) gives element i (in
// fp32, already rounded to T), which is staged in xv; returns 1 / rms.
// Thread t sums the squares of elements t, t + kThreads, ... (kBatch loads
// at a time) with fmaf, the block sums the threads (block_sum), then
// rsqrtf(total / D + eps). The block_sum barrier publishes xv.
template <typename Load>
__device__ __forceinline__ float norm_stats(Load load, float* xv, int D, float eps,
                                            float* scratch) {
  float ss = 0.f;
  #pragma unroll 1
  for (int i0 = threadIdx.x; i0 < D; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = 0.f;
      if (i >= D) continue;
      v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= D) continue;
      xv[i] = v[u];
      ss = fmaf(v[u], v[u], ss);
    }
  }
  const float total = block_sum(ss, scratch);
  return rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(D)), eps));
}

// a normed element: x / rms * scale, rounded to T
template <typename T>
__device__ __forceinline__ float normed(float x, float rinv, float scale) {
  return Traits<T>::round_trip(__fmul_rn(__fmul_rn(x, rinv), scale));
}

// rotate `rows` head rows of HD values in place: [x1 c - x2 s, x2 c + x1 s]
// with angle float(pos) * freqs[d], as models.common.rope
template <typename T>
__device__ __forceinline__ void rope_rows(float* v, int rows, int pos, int HD,
                                          const float* freqs) {
  const int half = HD / 2;
  for (int i = threadIdx.x; i < rows * half; i += kThreads) {
    float* r = v + i / half * HD;
    const int d = i % half;
    const float ang = __fmul_rn(static_cast<float>(pos), freqs[d]);
    const float c = cosf(ang), s = sinf(ang);
    const float x1 = r[d], x2 = r[d + half];
    r[d] = Traits<T>::round_trip(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    r[d + half] = Traits<T>::round_trip(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
  }
}

// elements d0 .. d0 + V - 1 of a cache row (zeros past HD): one 16-byte
// load when `vec` (the row's chunks are aligned), the new row from shared
// memory (`fresh`)
template <typename T>
__device__ __forceinline__ void load_row(const T* row, int d0, int HD, bool vec, bool fresh,
                                         const float* fresh_row, float (&out)[Traits<T>::kVec]) {
  constexpr int V = Traits<T>::kVec;
  if (vec && !fresh) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = Traits<T>::to_f(e[v]);
    return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    out[v] = d0 + v >= HD ? 0.f : fresh ? fresh_row[d0 + v] : Traits<T>::to_f(row[d0 + v]);
}

// One attention pass: nh (<= kMaxPass) query heads qs (nh x HD, rotated,
// in shared memory) of one KV head against its cache rows kc / vc (row
// stride kvn, positions 0 .. nv - 1; position idx, if >= 0, is the new
// row, read from ks / vs in shared memory). Scores take a thread per
// position (fmaf over the head dims in order, then the scale), the
// softmax a warp per head (p rounded to T), the AV product a thread per
// (position group, head, V-wide chunk of dims) over the group's positions
// in order, then the groups summed in order (the groups, and so each
// head's sum order, independent of nh). out(i, o) receives output i
// (head i / HD, dim i % HD) rounded to T. sc holds nh x S scores, red the
// groups' sums (<= kThreads x V floats). The caller has made qs, ks and
// vs visible to the block; ends with a barrier.
template <typename T, typename Out>
__device__ __forceinline__ void attend(const T* kc, const T* vc, int kvn, int HD, int S,
                                       int nv, int idx, bool vec_kv, const float* ks,
                                       const float* vs, const float* qs, int nh, float* sc,
                                       float* red, float attn_scale, Out out) {
  constexpr int V = Traits<T>::kVec;
  const int chunks = (HD + V - 1) / V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // scores: a thread per position, every head of the pass from one read of
  // its K row
  #pragma unroll 1
  for (int pos = threadIdx.x; pos < nv; pos += kThreads) {
    const T* krow = kc + static_cast<size_t>(pos) * kvn;
    float acc[kMaxPass];
#pragma unroll
    for (int hh = 0; hh < kMaxPass; ++hh) acc[hh] = 0.f;
    for (int d0 = 0; d0 < HD; d0 += V) {
      float kv[V];
      load_row(krow, d0, HD, vec_kv, pos == idx, ks, kv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (d0 + v >= HD) break;
#pragma unroll
        for (int hh = 0; hh < kMaxPass; ++hh)
          if (hh < nh) acc[hh] = fmaf(qs[hh * HD + d0 + v], kv[v], acc[hh]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < kMaxPass; ++hh)
      if (hh < nh) sc[hh * S + pos] = __fmul_rn(acc[hh], attn_scale);
  }
  __syncthreads();
  // softmax, a warp per head; p rounds to T
  for (int hh = warp; hh < nh; hh += kWarps) {
    float* s = sc + hh * S;
    float m = __int_as_float(0xff800000);  // -inf
    #pragma unroll 1
    for (int pos = lane; pos < nv; pos += 32) m = fmaxf(m, s[pos]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    #pragma unroll 1
    for (int pos = lane; pos < nv; pos += 32) {
      const float e = expf(__fsub_rn(s[pos], m));
      s[pos] = e;
      sum = __fadd_rn(sum, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int pos = lane; pos < nv; pos += 32)
      s[pos] = Traits<T>::round_trip(__fdiv_rn(s[pos], sum));
  }
  __syncthreads();
  // AV: a thread per (position group, head, V-wide chunk of dims), each
  // group's positions in order; then the groups summed in order. The
  // groups are sized for a full pass (kMaxPass heads) whatever nh is, so a
  // head's terms fall into the same groups in every pass split: its output
  // does not depend on how many heads share the pass, and so neither on
  // the slot count nor on s_max, which size the passes
  const int units = nh * chunks, per = min(kMaxPass * chunks, kThreads);
  const int groups = kThreads / per;
  const int g = threadIdx.x / per;
  for (int u = threadIdx.x % per; g < groups && u < units; u += per) {
    const float* p = sc + u / chunks * S;
    const int d0 = u % chunks * V;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 2
    for (int pos = g; pos < nv; pos += groups) {
      float vv[V];
      load_row(vc + static_cast<size_t>(pos) * kvn, d0, HD, vec_kv, pos == idx, vs, vv);
      const float pp = p[pos];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(pp, vv[v], acc[v]);
    }
    float* r = red + (static_cast<size_t>(g) * nh + u / chunks) * HD + d0;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (d0 + v < HD) r[v] = acc[v];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * HD; i += kThreads) {
    float o = red[i];
    #pragma unroll 1
    for (int gi = 1; gi < groups; ++gi) o = __fadd_rn(o, red[gi * nh * HD + i]);
    out(i, Traits<T>::round_trip(o));
  }
  __syncthreads();
}

// the FFN gate: silu(u) rounded to T, times g, rounded to T
template <typename T>
__device__ __forceinline__ float gate(float u, float g) {
  const float s = Traits<T>::round_trip(__fdiv_rn(u, __fadd_rn(1.f, expf(-u))));
  return Traits<T>::round_trip(__fmul_rn(s, g));
}

}  // namespace drows
