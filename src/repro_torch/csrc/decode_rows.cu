// The per-layer decode step's row kernels, for Hopper (sm_90a): RMSNorm,
// RoPE, decode attention and the silu gate of one token per slot, each a
// thin __global__ over decode_rows_core.cuh, the per-element code the fused
// decode kernel (decode_fused.cu, B2) runs for the same ops. So a
// per-layer decode step on the card (kernels/decode_rows.py, launched by
// models/common.py, models/attention.py and models/lm.py on CUDA tensors
// of one token per slot) gives the fused step's norms, K/V rows, attention
// outputs and gate products bit for bit, and through the shared DAC and
// B1's MVMs the same codes: paged, rectangular and fused serving agree.
//
// These are not ports of a TPU kernel: the reference runs these ops as XLA
// ops inside its jitted per-layer step. Their plain versions (today's
// PyTorch ops: models/common.py::rmsnorm_apply, ::rope,
// models/attention.py::decode_attention, the gate of models/lm.py) live in
// kernels/decode_rows.py.
//
// Bound: each is a few MB at tinyllama-1.1b width (8 slots): bytes over
// HBM bound them at microseconds; launch latency sets their time. The
// design keeps B2's order and nothing else: a block per slot for the norm
// (B2's row item), a block per (slot, KV head, pass of query heads) for
// attention (B2's attention item, with the same heads per pass), a thread
// per element pair for RoPE and per element for the gate.
//
// Each launcher returns cudaGetLastError() after the launch (0 = ok); the
// wrappers allocate every output.

#include <cuda_bf16.h>

#include "decode_rows_core.cuh"

namespace {

using amvm::kThreads;
using amvm::Traits;
using bf16 = __nv_bfloat16;

// out = RMSNorm(x) * scale per row of D, rounded to T; a block per row
template <typename T>
__global__ void __launch_bounds__(kThreads) norm_kernel(const T* __restrict__ x,
                                                         const float* __restrict__ scale,
                                                         T* __restrict__ out, int D, float eps) {
  extern __shared__ float xv[];  // (D,)
  __shared__ float scratch[amvm::kWarps];
  const size_t row = static_cast<size_t>(blockIdx.x) * D;
  const float rinv = drows::norm_stats([&](int i) { return Traits<T>::to_f(x[row + i]); }, xv,
                                       D, eps, scratch);
  for (int i = threadIdx.x; i < D; i += kThreads)
    out[row + i] = Traits<T>::from_f(drows::normed<T>(xv[i], rinv, scale[i]));
}

// q (B, H, HD) and k (B, KV, HD) rows rotated in place at position pos[b];
// a block per slot, the slot's rows staged in shared memory
template <typename T>
__global__ void __launch_bounds__(kThreads) rope_kernel(T* __restrict__ q, T* __restrict__ k,
                                                         const int* __restrict__ pos,
                                                         const float* __restrict__ freqs,
                                                         int H, int KV, int HD) {
  extern __shared__ float rows[];  // ((H + KV) x HD)
  const int b = blockIdx.x, n = (H + KV) * HD;
  T* qb = q + static_cast<size_t>(b) * H * HD;
  T* kb = k + static_cast<size_t>(b) * KV * HD;
  for (int i = threadIdx.x; i < n; i += kThreads)
    rows[i] = Traits<T>::to_f(i < H * HD ? qb[i] : kb[i - H * HD]);
  __syncthreads();
  drows::rope_rows<T>(rows, H + KV, pos[b], HD, freqs);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (i < H * HD)
      qb[i] = Traits<T>::from_f(rows[i]);
    else
      kb[i - H * HD] = Traits<T>::from_f(rows[i]);
  }
}

// decode attention of q (B, H, HD) against the cache (B, S, KV, HD), whose
// new rows are already written: positions < min(lens[b], S). An item is
// (slot, KV head, pass of hp query heads), as B2's; out (B, H, HD).
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_kernel(const T* __restrict__ q,
                                                         const T* __restrict__ kc,
                                                         const T* __restrict__ vc,
                                                         const int* __restrict__ lens,
                                                         T* __restrict__ out, int S, int H,
                                                         int KV, int HD, int hp, int vec,
                                                         float attn_scale) {
  extern __shared__ float work[];  // qs (hp x HD), scores (hp x S), AV sums
  const int G = H / KV, kvn = KV * HD, passes = (G + hp - 1) / hp;
  const int it = blockIdx.x;
  const int b = it / (KV * passes), kvh = it / passes % KV, h0 = it % passes * hp;
  const int nh = min(hp, G - h0);
  const int q0 = (kvh * G + h0) * HD;
  float* qs = work;
  float* sc = qs + hp * HD;
  float* red = sc + hp * S;
  const T* qb = q + static_cast<size_t>(b) * H * HD;
  for (int i = threadIdx.x; i < nh * HD; i += kThreads) qs[i] = Traits<T>::to_f(qb[q0 + i]);
  __syncthreads();
  const size_t base = static_cast<size_t>(b) * S * kvn + kvh * HD;
  T* ob = out + static_cast<size_t>(b) * H * HD;
  drows::attend<T>(kc + base, vc + base, kvn, HD, S, min(lens[b], S), -1, vec != 0, nullptr,
                   nullptr, qs, nh, sc, red, attn_scale,
                   [&](int i, float o) { ob[q0 + i] = Traits<T>::from_f(o); });
}

// h = silu(u) * g per element, as B2's gate
template <typename T>
__global__ void __launch_bounds__(kThreads) gate_kernel(const T* __restrict__ u,
                                                         const T* __restrict__ g,
                                                         T* __restrict__ h, int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads)
    h[i] = Traits<T>::from_f(drows::gate<T>(Traits<T>::to_f(u[i]), Traits<T>::to_f(g[i])));
}

int set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int norm(const void* x, const void* scale, void* out, int B, int D, float eps,
         cudaStream_t s) {
  const int smem = D * 4;
  if (int rc = set_smem(reinterpret_cast<const void*>(norm_kernel<T>), smem)) return rc;
  norm_kernel<T><<<B, kThreads, smem, s>>>(static_cast<const T*>(x),
                                           static_cast<const float*>(scale),
                                           static_cast<T*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rope(void* q, void* k, const void* pos, const void* freqs, int B, int H, int KV, int HD,
         cudaStream_t s) {
  const int smem = (H + KV) * HD * 4;
  if (int rc = set_smem(reinterpret_cast<const void*>(rope_kernel<T>), smem)) return rc;
  rope_kernel<T><<<B, kThreads, smem, s>>>(static_cast<T*>(q), static_cast<T*>(k),
                                           static_cast<const int*>(pos),
                                           static_cast<const float*>(freqs), H, KV, HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attn(const void* q, const void* kc, const void* vc, const void* lens, void* out, int B,
         int S, int H, int KV, int HD, int hp, int vec, float scale, cudaStream_t s) {
  const int passes = (H / KV + hp - 1) / hp;
  const int smem = (hp * HD + hp * S + kThreads * Traits<T>::kVec) * 4;
  if (int rc = set_smem(reinterpret_cast<const void*>(attn_kernel<T>), smem)) return rc;
  attn_kernel<T><<<B * KV * passes, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(lens), static_cast<T*>(out), S, H, KV, HD, hp, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gate(const void* u, const void* g, void* h, int n, cudaStream_t s) {
  const int blocks = min((n + kThreads - 1) / kThreads, 4096);
  gate_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(u),
                                             static_cast<const T*>(g), static_cast<T*>(h), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int decode_rows_norm(const void* x, const void* scale, void* out, int B, int D,
                                float eps, int dtype, void* stream) {
  if (B < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return norm<float>(x, scale, out, B, D, eps, s);
  if (dtype == 1) return norm<bf16>(x, scale, out, B, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_rows_rope(void* q, void* k, const void* pos, const void* freqs, int B,
                                int H, int KV, int HD, int dtype, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || HD < 2 || HD % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rope<float>(q, k, pos, freqs, B, H, KV, HD, s);
  if (dtype == 1) return rope<bf16>(q, k, pos, freqs, B, H, KV, HD, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_rows_attn(const void* q, const void* kc, const void* vc,
                                const void* lens, void* out, int B, int S, int H, int KV,
                                int HD, int hp, int vec, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV || hp < 1 || hp > drows::kMaxPass)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return attn<float>(q, kc, vc, lens, out, B, S, H, KV, HD, hp, vec, scale, s);
  if (dtype == 1) return attn<bf16>(q, kc, vc, lens, out, B, S, H, KV, HD, hp, vec, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_rows_gate(const void* u, const void* g, void* h, int n, int dtype,
                                void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gate<float>(u, g, h, n, s);
  if (dtype == 1) return gate<bf16>(u, g, h, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
