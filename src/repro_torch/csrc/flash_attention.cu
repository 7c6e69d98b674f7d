// Prefill attention for Hopper (sm_90a): causal or full attention forward
// with an online softmax, GQA by head grouping.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention_fwd, pallas_call at flash_attention.py:117).
// It computes what the port's plain version computes
// (src/repro_torch/kernels/ref.py::flash_attention_ref, the reference's
// models/attention.py::chunked_attention), in its rounding points:
//
//   s[i,j] = (sum_d q[i,d] * k[j,d]) * D^-0.5    (fp32; scaled after QK^T)
//   s[i,j] = NEG_INF (-1e30) where j >= S, or j > i when causal
//   per KV chunk of `chunk` keys (the plain version's kv_chunk,
//   ModelConfig.attn_chunk_kv):
//                 m' = max(m, max_j s)   alpha = exp(m - m')
//                 p = exp(s - m')        l = l * alpha + sum_j p
//                 acc = acc * alpha + sum_j (float)(T)p * v[j]
//   o[i] = (T)(acc / max(l, 1e-30))
//
// with m, l and acc in fp32, p rounded to v's dtype T before PV, accurate
// expf (the build has no fast-math), and _rn intrinsics where the plain
// version rounds after a product, so the compiler contracts nothing the
// plain version rounds twice. The softmax is updated at the plain version's
// chunk boundaries, not at the kernel's 64-key tiles, so each p is formed
// against the same running max and rounds to bf16 at the same point: a
// chunk is walked twice, once for its row max and once for p, its row sum
// and PV (QK^T is computed twice; the price of matching the rounding).
//
// Layout: q (B, S, H, D), k and v (B, S, Kv, D), o (B, S, H, D), all
// contiguous, as the port's attention already holds them: no transposes and
// no materialized GQA broadcast -- query head h reads KV head h / (H / Kv).
//
// Shape stability, the contract of bucketed prefill: a real query row's
// output is bitwise independent of right-padding. The KV tile (64 rows) is a
// compile-time constant and the chunk a constant of the model, neither
// depends on S; a q tile walks only the keys up to its diagonal (causal) or
// up to S (full); masked scores are NEG_INF, so their p is an exact 0 and
// their products leave every partial sum's bits unchanged (the sums start
// at +0), and a chunk with no live key for a row leaves m, l and acc as
// they were (alpha = 1); the order of every reduction of a row (the dot
// over D, the row max and row sum over a tile, the PV sum, the tile and
// chunk walk) depends on the row alone. Rows past S are computed from zero
// q and never written; K/V rows past S are staged as zeros.
//
// Bound: at the prefill shapes (S <= 2048, D = 64, bf16) the work is
// 2*S^2*D*H operations per row causal against (2H + 2Kv)*S*D*2 bytes, far
// above the card's bytes-per-operation line: bound by operations (dense
// bf16 tensor-core peak). This first kernel is the simple, right one: one
// block of 256 threads per (q tile of 64 rows, head, batch row); Q, K and V
// tiles staged through shared memory as fp32 (rows padded to D + 1 words
// against bank conflicts); each thread owns a 4 x 4 block of scores and a
// 4 x D/16 block of the output, all products fp32 FMA on the CUDA cores (no
// TF32, no tensor cores), the online softmax in fp32 registers and the row
// reductions as 16-lane butterflies (identical bits on every lane). wgmma,
// TMA and a warp-specialized pipeline are later work. The kernel allocates
// nothing and runs on the caller's stream; the launcher returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // q rows per block, KV rows per tile
constexpr int kThreads = 256;  // (ty, tx) in 16 x 16
constexpr int kRows = 4;       // q rows per thread: 4 ty + i
constexpr int kCols = 4;       // score columns per thread: tx + 16 j
constexpr int kPLd = kTile + 1;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// butterfly: at every level each lane adds the same two partial sums, so
// every lane of the 16 ends with the same bits
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int D>
constexpr int smem_floats() {
  return 3 * kTile * (D + 1) + kTile * kPLd;
}

// (4 x 4) block of q . k dot products of thread (ty, tx): q rows 4 ty + i,
// tile keys tx + 16 j; each a sequential fp32 FMA chain over d
template <int D>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks,
                                            int ty, int tx,
                                            float (&sc)[kRows][kCols]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kRows], kv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) qv[i] = Qs[(kRows * ty + i) * LD + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
  }
}

// stage rows [r0, r0 + kTile) of a (S, row_stride) operand as fp32; rows
// past S are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long row_stride,
                                      int r0, int S, int tid) {
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, s = r0 + r;
    dst[r * (D + 1) + c] = s < S ? Io<T>::load(src + s * row_stride + c) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KV, int causal, int chunk, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  constexpr int LD = D + 1;
  constexpr int kOut = D / 16;  // output columns per thread: tx + 16 c
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * kTile;
  const long q_row = static_cast<long>(H) * D;
  const long kv_row = static_cast<long>(KV) * D;
  const T* qb = q + static_cast<long>(b) * S * q_row + static_cast<long>(h) * D;
  const T* kb = k + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;
  const T* vb = v + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;
  T* ob = o + static_cast<long>(b) * S * q_row + static_cast<long>(h) * D;

  stage<T, D>(Qs, qb, q_row, q0, S, tid);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  // keys this q tile can attend to: [0, key_end)
  const int key_end = causal ? min(S, q0 + kTile) : S;
  float sc[kRows][kCols];
  for (int c0 = 0; c0 < key_end; c0 += chunk) {
    const int c1 = min(c0 + chunk, key_end);
    const int t0 = c0 / kTile, t1 = (c1 + kTile - 1) / kTile;
    // key kp of tile row j is live for q row qp: inside this chunk, below
    // S and, when causal, not after qp
    auto live = [&](int kp, int qp) {
      return kp >= c0 && kp < c0 + chunk && kp < S && (!causal || kp <= qp);
    };

    // pass 1: the row max over the chunk
    float cm[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) cm[i] = kNegInf;
    for (int t = t0; t < t1; ++t) {
      __syncthreads();  // earlier reads of Ks are done (and Qs is staged)
      stage<T, D>(Ks, kb, kv_row, t * kTile, S, tid);
      __syncthreads();
      tile_scores<D>(Qs, Ks, ty, tx, sc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int qp = q0 + kRows * ty + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int kp = t * kTile + tx + 16 * j;
          if (live(kp, qp)) cm[i] = fmaxf(cm[i], __fmul_rn(sc[i][j], scale));
        }
      }
    }
    float m_new[kRows], alpha[kRows], cs[kRows], pv[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m_new[i] = fmaxf(m[i], row_max16(cm[i]));
      alpha[i] = expf(m[i] - m_new[i]);
      cs[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kOut; ++c) pv[i][c] = 0.f;
    }

    // pass 2: p against the chunk's max, its row sum, and PV
    for (int t = t0; t < t1; ++t) {
      __syncthreads();  // earlier reads of Ks, Vs and Ps are done
      stage<T, D>(Ks, kb, kv_row, t * kTile, S, tid);
      stage<T, D>(Vs, vb, kv_row, t * kTile, S, tid);
      __syncthreads();
      tile_scores<D>(Qs, Ks, ty, tx, sc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = kRows * ty + i, qp = q0 + row;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int kp = t * kTile + tx + 16 * j;
          const float s = live(kp, qp) ? __fmul_rn(sc[i][j], scale) : kNegInf;
          const float p = expf(s - m_new[i]);
          ps = __fadd_rn(ps, p);
          Ps[row * kPLd + tx + 16 * j] = Io<T>::round(p);
        }
        cs[i] = __fadd_rn(cs[i], row_sum16(ps));
      }
      __syncthreads();  // P is complete
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float pj[kRows], vj[kOut];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pj[i] = Ps[(kRows * ty + i) * kPLd + j];
#pragma unroll
        for (int c = 0; c < kOut; ++c) vj[c] = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kOut; ++c) pv[i][c] = fmaf(pj[i], vj[c], pv[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), cs[i]);
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha[i]), pv[i][c]);
      m[i] = m_new[i];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + kRows * ty + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      Io<T>::store(ob + qp * q_row + tx + 16 * c, __fdiv_rn(acc[i][c], denom));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int chunk, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int D, int causal, int chunk,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, chunk, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, chunk, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, chunk, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, chunk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64, 128}; H a multiple
// of KV. Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int D, int causal,
                                      int chunk, float scale, int dtype,
                                      void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, H, KV, D, causal, chunk, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, chunk,
                                   scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
