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
//   s[i,j] = NEG_INF (-1e30) where j >= S, or j > i when causal, or
//            i - j >= window when a local window is set (window > 0)
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
// The local window (recurrentgemma's attention layers). A row's live keys
// are (i - window, i]; the plain version walks every chunk from key 0, and
// a row's wholly masked leading chunks form p = 1 against m = NEG_INF
// (exp(NEG_INF - NEG_INF) = 1), which the first live chunk's alpha =
// exp(NEG_INF - m') = 0 wipes: l = 0 * l + cs and acc = 0 * acc + pv. So a
// block may start its walk at the key tile holding key q0 - window + 1 (q0
// its first position; every key before it is masked for every row of the
// block): the wiped state then starts from zeros instead, and the sums
// after the wipe carry the same bits (0 * x + y == y, the one exception a
// pv of -0 against a negative wiped acc, which gives +0 for -0). `skip` = 0
// walks from key 0 as the plain version does: chip_smoke.py holds the two
// walks bitwise equal at the window shapes it launches.
//
// Bound: at the prefill shapes (S <= 2048, D = 64 to 256, bf16) the work
// is 4*D*H*sum_i(live keys of row i) operations (causal: S(S+1)/2 keys,
// windowed: sum_i min(i + 1, window)) against (2H + 2Kv)*S*D*2 bytes, far
// above the card's bytes-per-operation line: bound by operations (dense
// bf16 tensor-core peak). bf16 runs on the tensor cores (the second kernel
// below). fp32 keeps the CUDA-core kernel (TF32 would round the scores):
// one block of 256 threads per (q tile of 64 rows, head, batch row); Q, K
// and V tiles staged through shared memory as fp32 (rows padded to D + 1
// words against bank conflicts); each thread owns a 4 x 4 block of scores
// and a 4 x D/16 block of the output, all products fp32 FMA on the CUDA
// cores, the online softmax in fp32 registers and the row reductions as
// 16-lane butterflies (identical bits on every lane). wgmma, TMA and a
// warp-specialized pipeline are later work. The kernels allocate nothing
// and run on the caller's stream; the launchers return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                       int H, int KV, int causal, int window, int skip, int chunk,
                       float scale) {
  static_assert(D % 16 == 0 && D <= 256, "head dim");
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

  // keys this q tile can attend to: [key_start, key_end)
  const int key_end = causal ? min(S, q0 + kTile) : S;
  const int key_start = skip && window ? max(0, q0 - window + 1) : 0;
  float sc[kRows][kCols];
  for (int c0 = key_start / chunk * chunk; c0 < key_end; c0 += chunk) {
    const int c1 = min(c0 + chunk, key_end);
    const int t0 = max(c0, key_start) / kTile, t1 = (c1 + kTile - 1) / kTile;
    // key kp of tile row j is live for q row qp: inside this chunk, below
    // S, when causal not after qp, and inside the window
    auto live = [&](int kp, int qp) {
      return kp >= c0 && kp < c0 + chunk && kp < S && (!causal || kp <= qp) &&
             (!window || qp - kp < window);
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

// ------------------------------------------------------------ bf16 on tensor cores
//
// The bf16 kernel computes the same function at the same rounding points on
// the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators):
// QK^T from bf16 q and k, then the fp32 scale with __fmul_rn; the online
// softmax in fp32 registers at the plain version's chunk boundaries; p
// rounded to bf16 as the A operand of PV (the C fragment of QK^T is the A
// fragment of PV, so p never leaves the registers); m, l, acc and each
// chunk's PV sum in fp32, combined as above with _rn intrinsics.
//
// Why mma.sync: a 16-row tile per warp lets one block serve all the query
// heads of a KV head from one copy of each K/V tile (below); wgmma's
// 64-row tiles would need 64 positions per head per block.
//
// Holding the plain version's rounding points on tensor cores. The tensor
// cores sum a score's 64 products in another order than the plain
// version's fp32 FMA chain, so about half the scores differ in their last
// bits. That alone is harmless, but p is rounded to bf16: where p's fp32
// value lies next to a bf16 rounding midpoint, the last bit decides which
// way it rounds, and one flipped p of weight ~0.5 moves a small output by
// several output ulps (measured on an H100: up to 9 ulps against the
// one-ulp bound). So the kernel holds the two places
// where a score's last bits matter to the plain version's values:
// - the chunk max m: each lane keeps its best two tensor-core scores per
//   row, and the max is taken over the plain version's scores of those
//   keys (fma_score_g: the FMA chain over d, in the plain order); every
//   other key is far enough below;
// - p near a midpoint (fp32 bits within kPWindow of it, ~0.1% of p's):
//   recomputed from the plain version's score (fma_score, from shared
//   memory), one flagged p per lane per round, out of the hot loop.
// Every other p is formed from the tensor-core score and rounds to the
// same bf16 value as the plain version's p. PV's sum over keys also runs
// in the tensor cores' order: an output near zero (its terms cancel) can
// move by hundreds of its own ulps, all within the bound's absolute term
// (1e-5 x max |o|), where the CUDA-core bf16 kernel this one replaced
// kept every output within one ulp.
//
// The chunk max: p must be formed against the max over the whole chunk
// (1024 keys), and a 64-row q tile's fp32 scores over a chunk (256 KB) fit
// neither registers nor shared memory; QK^T is cheap on the tensor cores,
// so each chunk is walked twice -- pass 1 computes QK^T for the row max,
// pass 2 computes it again (the same instructions on the same operands,
// so the same bits) for p, the row sums and PV. 1.5x the plain product
// count, for the plain version's rounding points.
//
// GQA: a block owns one KV head and serves its query heads from one copy
// of each K/V tile: 8 warps of 16 query rows each, HB = gcd(H / Kv, 8)
// heads x 8 / HB groups of 16 positions (tinyllama, 8 heads per KV head:
// 8 heads x 16 positions). K and V tiles of 64 keys stream through a
// 4-deep cp.async ring; Q is staged once per block. Every shape
// constant (64-key tile, 16 x 8 / HB positions per block, the chunk) is
// independent of S, so the right-padding contract above holds unchanged:
// a block walks the keys up to min(S, its last position + 1) causal,
// masked scores are NEG_INF with an exact-zero p, a chunk with no live key
// for a row leaves m, l and acc as they were, and each row's reductions
// (the per-thread sums in fixed order, then a fixed 4-lane butterfly) are
// the row's alone.
//
// D = 256 (recurrentgemma, paligemma). A warp's 16 x 256 fp32 accumulator
// and its chunk's PV sum would be 256 registers a thread; so two warps
// share each 16 rows, each owning 128 output columns (acc and pv 64
// registers each, as at D = 128): both compute the rows' whole QK^T, with
// the same instructions on the same operands, so the same scores, max and
// p. HB = gcd(G, 4) heads x 4 / HB position groups. Q (8 warps x 16 rows,
// 64 KB) plus a 4-deep K/V ring (256 KB) would pass the 227 KB a block may
// have, so the ring is 2 deep at D = 256 (Q 64 KB + ring 128 KB = 192 KB).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
// K (and V) tiles in flight: a ring of 4, of 2 at D = 256
template <int D>
__host__ __device__ constexpr int tc_stages() {
  return D > 128 ? 2 : 4;
}
// warps sharing 16 rows, each with D / tc_halves output columns
template <int D>
__host__ __device__ constexpr int tc_halves() {
  return D > 128 ? 2 : 1;
}
// a p whose fp32 bits lie within kPWindow units of the last place below or
// above a bf16 rounding midpoint (low 16 bits 0x8000) is recomputed from the
// plain version's score (a window of 2^-18 of p; ~0.1% of p's). Both
// windows come from a sweep on an H100: tools/b3_accuracy.py builds the
// kernel with -DFA_P_WINDOW / -DFA_MAX_WINDOW and reports, per setting and
// seed, the outputs over the bound (PERF.md, section 6, has the readings).
#ifndef FA_P_WINDOW
#define FA_P_WINDOW 32
#endif
constexpr int kPWindow = FA_P_WINDOW;
// a lane's second-best score of a chunk within kMaxWindow x max(1, |best|)
// of its best is recomputed too for the chunk max
#ifndef FA_MAX_WINDOW
#define FA_MAX_WINDOW (1.f / 4096)
#endif
constexpr float kMaxWindow = FA_MAX_WINDOW;

// rows of D / 8 16-byte chunks; chunk c of row r at c ^ (r & mask)
template <int D>
__device__ __forceinline__ int tc_swz(int row, int chunk) {
  constexpr int NC = D / 8;
  constexpr int mask = (NC < 8 ? NC : 8) - 1;
  return row * NC + (chunk ^ (row & mask));
}

template <int D>
constexpr int tc_smem_bytes() {
  return (kTcWarps * 16 + 2 * tc_stages<D>() * kTile) * D * 2;  // Q, then the K/V ring
}

// the plain version's score of one (q row, key row) pair from shared memory:
// a sequential fp32 FMA chain over d from zero, then the scale (out of line:
// a rare path, kept out of the hot loop's instruction stream)
template <int D>
__device__ __noinline__ float fma_score(const __nv_bfloat16* qw, int qr,
                                           const __nv_bfloat16* kt, int kr, float scale) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const __nv_bfloat16* qc = qw + tc_swz<D>(qr, c) * 8;
    const __nv_bfloat16* kc = kt + tc_swz<D>(kr, c) * 8;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc = fmaf(__bfloat162float(qc[u]), __bfloat162float(kc[u]), acc);
  }
  return __fmul_rn(acc, scale);
}

// the same, with the key row read from device memory (the chunk max is
// settled after the chunk's tiles have left shared memory)
template <int D>
__device__ __noinline__ float fma_score_g(const __nv_bfloat16* qw, int qr,
                                          const __nv_bfloat16* krow, float scale) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const __nv_bfloat16* qc = qw + tc_swz<D>(qr, c) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 8);
    const __nv_bfloat16* kc = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc = fmaf(__bfloat162float(qc[u]), __bfloat162float(kc[u]), acc);
  }
  return __fmul_rn(acc, scale);
}

__device__ __forceinline__ bool near_bf16_midpoint(float p) {
  const int lo = static_cast<int>(__float_as_uint(p) & 0xFFFFu);
  return abs(lo - 0x8000) < kPWindow;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          int S, int H, int KV, int HB, int causal, int window, int skip,
                          int chunk, float scale) {
  static_assert(D % 16 == 0 && D <= 256, "head dim");
  constexpr int kTcStages = tc_stages<D>();
  constexpr int NH = tc_halves<D>();  // warps per 16 rows
  constexpr int DV = D / NH;          // output columns of a warp
  constexpr int NC = D / 8;   // 16-byte chunks per row
  constexpr int NT = DV / 8;  // n8 tiles of a warp's output
  constexpr int KT = kTile / 8;  // n8 tiles of a score tile
  static_assert(KT * 4 <= 32, "one flag bit per score of a thread");
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t qs = smem_u32(tc_smem);
  const uint32_t ks0 = qs + kTcWarps * 16 * D * 2;
  constexpr uint32_t kTileBytes = kTile * D * 2;

  const int G = H / KV, PG = kTcWarps / NH / HB, BQ = 16 * PG;
  const int kvh = blockIdx.y / (G / HB), hg = blockIdx.y % (G / HB);
  const int b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = warp % NH, wq = warp / NH;  // output columns, row group
  const int h = kvh * G + hg * HB + wq % HB;   // this warp's query head
  const int p0 = q0 + (wq / HB) * 16;          // and its first position
  const long q_row = static_cast<long>(H) * D, kv_row = static_cast<long>(KV) * D;
  const __nv_bfloat16* kb = k + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;
  const __nv_bfloat16* vb = v + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;

  // Q of every warp: warp w's 16 rows at qs + w * 16 * D * 2
#pragma unroll
  for (int it = 0; it < kTcWarps * 16 * NC / kTcThreads; ++it) {
    const int i = tid + it * kTcThreads, wr = i / NC, c = i % NC, w = wr / 16, r = wr % 16;
    const int hh = kvh * G + hg * HB + (w / NH) % HB, pos = q0 + (w / NH / HB) * 16 + r;
    const bool ok = pos < S;
    const __nv_bfloat16* src =
        q + (static_cast<long>(b) * S + (ok ? pos : 0)) * q_row + static_cast<long>(hh) * D + c * 8;
    cp_async16(qs + (w * 16 * NC + tc_swz<D>(r, c)) * 16, src, ok);
  }
  cp_async_commit();

  // K (and V) tile t into ring slot: rows past S are zero
  auto load_tile = [&](int t, int slot, bool with_v) {
    const uint32_t kd = ks0 + slot * 2 * kTileBytes, vd = kd + kTileBytes;
#pragma unroll
    for (int it = 0; it < (kTile * NC + kTcThreads - 1) / kTcThreads; ++it) {
      const int i = tid + it * kTcThreads;
      if (kTile * NC % kTcThreads && i >= kTile * NC) break;
      const int r = i / NC, c = i % NC, kp = t * kTile + r;
      const bool ok = kp < S;
      const long off = static_cast<long>(ok ? kp : 0) * kv_row + c * 8;
      cp_async16(kd + tc_swz<D>(r, c) * 16, kb + off, ok);
      if (with_v) cp_async16(vd + tc_swz<D>(r, c) * 16, vb + off, ok);
    }
  };

  // rows of this thread: p0 + lane / 4 and eight below
  const int g = lane >> 2;
  const int qp[2] = {p0 + g, p0 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const uint32_t qw = qs + warp * 16 * NC * 16;
  // the same shared memory as plain pointers, for the FMA scores
  const __nv_bfloat16* qwp =
      reinterpret_cast<const __nv_bfloat16*>(tc_smem) + warp * 16 * D;
  auto ktile = [&](int slot) {
    return reinterpret_cast<const __nv_bfloat16*>(tc_smem) + kTcWarps * 16 * D +
           slot * 2 * kTile * D;
  };
  // the scaled, masked scores of tile t against this warp's 16 rows
  auto scores = [&](int t, int slot, int c0, float (&sc)[KT][4]) {
    const uint32_t kd = ks0 + slot * 2 * kTileBytes;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(qw + tc_swz<D>(lane & 15, 2 * kk + (lane >> 4)) * 16, a);
#pragma unroll
      for (int jp = 0; jp < KT / 2; ++jp) {
        uint32_t bb[4];
        const int i = lane >> 3;
        ldsm_x4(kd + tc_swz<D>(jp * 16 + (i >> 1) * 8 + (lane & 7), 2 * kk + (i & 1)) * 16, bb);
        mma_bf16(sc[2 * jp], a, bb[0], bb[1]);
        mma_bf16(sc[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
    // a tile inside the chunk, below S, (causal) below this warp's first
    // row and inside its last row's window is live throughout: no mask
    const int k0 = t * kTile;
    const bool all_live = k0 >= c0 && k0 + kTile <= min(c0 + chunk, S) &&
                          (!causal || k0 + kTile - 1 <= p0) &&
                          (!window || p0 + 15 - k0 < window);
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
        const int row = qp[e >> 1];
        const bool live =
            all_live || (kp >= c0 && kp < c0 + chunk && kp < S && (!causal || kp <= row) &&
                         (!window || row - kp < window));
        sc[j][e] = live ? __fmul_rn(sc[j][e], scale) : kNegInf;
      }
  };

  const int key_end = causal ? min(S, q0 + BQ) : S;
  // every key before key_start is masked for every row of the block (see
  // the header on the window)
  const int key_start = skip && window ? max(0, q0 - window + 1) : 0;
  float sc[KT][4];
  for (int c0 = key_start / chunk * chunk; c0 < key_end; c0 += chunk) {
    const int c1 = min(c0 + chunk, key_end);
    const int t0 = max(c0, key_start) / kTile, t1 = (c1 + kTile - 1) / kTile;

    // pass 1: the row max over the chunk, exact: each lane keeps its best
    // two tensor-core scores per row, and the plain version's scores of
    // those keys (the second only where it is within kMaxWindow of the
    // first) settle the max -- the other keys are below it by far more than
    // the two orders of summation differ
    float b1[2] = {kNegInf, kNegInf}, b2[2] = {kNegInf, kNegInf};
    int k1[2] = {-1, -1}, k2[2] = {-1, -1};
#pragma unroll
    for (int i = 0; i < kTcStages - 1; ++i) {
      if (t0 + i < t1) load_tile(t0 + i, i, false);
      cp_async_commit();
    }
    for (int t = t0; t < t1; ++t) {
      const int slot = (t - t0) % kTcStages;
      cp_async_wait<kTcStages - 2>();
      __syncthreads();  // tile t (and Q) landed; the slot of tile t - 1 is free
      if (t + kTcStages - 1 < t1)
        load_tile(t + kTcStages - 1, (slot + kTcStages - 1) % kTcStages, false);
      cp_async_commit();
      scores(t, slot, c0, sc);
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kp = t * kTile + j * 8 + (lane & 3) * 2 + (e & 1);
          const float s = sc[j][e];  // masked: NEG_INF, never above b1 or b2
          if (s > b1[r]) {
            b2[r] = b1[r];
            k2[r] = k1[r];
            b1[r] = s;
            k1[r] = kp;
          } else if (s > b2[r]) {
            b2[r] = s;
            k2[r] = kp;
          }
        }
    }
    float cm[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (k1[r] >= 0) cm[r] = fma_score_g<D>(qwp, g + 8 * r, kb + k1[r] * kv_row, scale);
      if (k2[r] >= 0 && b2[r] >= b1[r] - kMaxWindow * fmaxf(1.f, fabsf(b1[r])))
        cm[r] = fmaxf(cm[r], fma_score_g<D>(qwp, g + 8 * r, kb + k2[r] * kv_row, scale));
    }
    float m_new[2], alpha[2], cs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(cm[r]));
      alpha[r] = expf(m[r] - m_new[r]);
    }

    // pass 2: p against the chunk's max, its row sum, and PV
    float pv[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with pass 1's buffers
#pragma unroll
    for (int i = 0; i < kTcStages - 1; ++i) {
      if (t0 + i < t1) load_tile(t0 + i, i, true);
      cp_async_commit();
    }
    for (int t = t0; t < t1; ++t) {
      const int slot = (t - t0) % kTcStages;
      cp_async_wait<kTcStages - 2>();
      __syncthreads();
      if (t + kTcStages - 1 < t1)
        load_tile(t + kTcStages - 1, (slot + kTcStages - 1) % kTcStages, true);
      cp_async_commit();
      scores(t, slot, c0, sc);
      // p near a bf16 rounding point is recomputed from the plain version's
      // score, so it rounds as the plain version's p does: the flagged
      // (j, e) of every lane, one per lane per round
      uint32_t flagged = 0;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[j][e] - m_new[e >> 1]);
          if (sc[j][e] != kNegInf && near_bf16_midpoint(p)) flagged |= 1u << (j * 4 + e);
          sc[j][e] = p;
        }
      const __nv_bfloat16* kt = ktile(slot);
      while (__any_sync(0xffffffffu, flagged != 0)) {
        if (flagged) {
          const int at = __ffs(flagged) - 1, r = (at & 3) >> 1;
          flagged &= flagged - 1;
          const float p = expf(
              fma_score<D>(qwp, g + 8 * r, kt, (at >> 2) * 8 + (lane & 3) * 2 + (at & 1), scale) -
              m_new[r]);
#pragma unroll
          for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j * 4 + e == at) sc[j][e] = p;
        }
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[e >> 1] = __fadd_rn(ps[e >> 1], sc[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) cs[r] = __fadd_rn(cs[r], quad_sum(ps[r]));
      const uint32_t vd = ks0 + slot * 2 * kTileBytes + kTileBytes;
#pragma unroll
      for (int kj = 0; kj < kTile / 16; ++kj) {
        const uint32_t a[4] = {pack_bf16(sc[2 * kj][0], sc[2 * kj][1]),
                               pack_bf16(sc[2 * kj][2], sc[2 * kj][3]),
                               pack_bf16(sc[2 * kj + 1][0], sc[2 * kj + 1][1]),
                               pack_bf16(sc[2 * kj + 1][2], sc[2 * kj + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(vd + tc_swz<D>(kj * 16 + (lane & 15), half * (DV / 8) + 2 * dp + (lane >> 4)) * 16,
                    bb);
          mma_bf16(pv[2 * dp], a, bb[0], bb[1]);
          mma_bf16(pv[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), cs[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], alpha[e >> 1]), pv[j][e]);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with pass 2's buffers
  }

  __nv_bfloat16* ob = o + static_cast<long>(b) * S * q_row + static_cast<long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp[r] >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = half * DV + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(ob + qp[r] * q_row + d) = __floats2bfloat162_rn(
          __fdiv_rn(acc[j][2 * r], denom), __fdiv_rn(acc[j][2 * r + 1], denom));
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int KV, int causal, int window, int skip, int chunk, float scale,
              cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<D>();
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int G = H / KV;
  constexpr int RW = kTcWarps / tc_halves<D>();  // warps of distinct rows
  int HB = 1;  // gcd(G, RW)
  while (HB < RW && G % (2 * HB) == 0) HB *= 2;
  const int BQ = 16 * (RW / HB);
  const dim3 grid((S + BQ - 1) / BQ, KV * (G / HB), B);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_tc_kernel<D><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, KV, HB,
      causal, window, skip, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int window, int skip, int chunk, float scale,
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
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, window, skip, chunk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

#define FA_ARGS q, k, v, o, B, S, H, KV, causal, window, skip, chunk, scale, s

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int D, int causal, int window, int skip, int chunk,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(FA_ARGS);
    case 32: return launch<T, 32>(FA_ARGS);
    case 64: return launch<T, 64>(FA_ARGS);
    case 128: return launch<T, 128>(FA_ARGS);
    case 256: return launch<T, 256>(FA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64, 128, 256}; H a
// multiple of KV; window 0 = none, else the local window (>= 1); skip 0
// walks every key from 0 (see the header). Returns cudaGetLastError() after
// the launch (0 = ok), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int D, int causal,
                                      int chunk, int window, int skip, float scale,
                                      int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 || chunk < 1 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, H, KV, D, causal, window, skip, chunk, scale, s);
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_tc<16>(FA_ARGS);
      case 32: return launch_tc<32>(FA_ARGS);
      case 64: return launch_tc<64>(FA_ARGS);
      case 128: return launch_tc<128>(FA_ARGS);
      case 256: return launch_tc<256>(FA_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
