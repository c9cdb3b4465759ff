// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/flash_attention.py:
//   _fwd_kernel      (launched by _flash_fwd_pallas)  -> flash_attention_fwd
//   _bwd_dq_kernel   (launched by _flash_bwd_pallas)  -> flash_attention_bwd_dq
//   _bwd_dkv_kernel  (launched by _flash_bwd_pallas)  -> flash_attention_bwd_dkv
//
// What they compute (the Pallas kernels' contract). Layout (BH, S, D), batch
// and heads flattened; k/v carry BH / kv_rep rows and query row b reads KV
// row b / kv_rep (GQA without repeated KV). Scores are fp32, (q·k)·scale;
// the mask keeps col < kv_limit and, when causal, row + causal_offset >=
// col; masked probabilities are exactly 0, so a row with nothing to attend
// gives out 0 and lse -1e30. With segment ids (seg_q (R, sq) and seg_k (R,
// sk) int32, query row bh reading row bh / seg_div; seg_div = BH / R, or BH
// for one row shared by every bh), the mask also keeps seg_q[row] ==
// seg_k[col] only: packed sequences attend within their own segment, and
// pads (-1 on the query side, -2 on the key side, set by the caller) attend
// nothing. Such a row's lse is -1e30, so the backward's exp(s - lse)
// overflows there; like every masked probability it is selected to 0, never
// multiplied by a mask. The forward keeps an online softmax and writes out
// (q's dtype) and the log-sum-exp (fp32). The backward takes the saved lse
// and delta = sum(dO * O) per row (computed by the caller) and recomputes
//   p = exp(s - lse), dp = dO·Vᵀ, ds = p·(dp - delta),
//   dQ = ds·K·scale, dV = pᵀ·dO, dK = dsᵀ·Q·scale,
// with dK/dV summed over each KV head's kv_rep query heads inside one block
// (no atomics: every sum has one fixed order, so a run repeats bitwise). As
// in the Pallas kernels, P is rounded to the input dtype before P·V in the
// forward, dS before dQ and dK, and dO before dP; every sum is fp32. dV is
// the one product the Pallas kernel takes with P in fp32 (its dO is cast to
// fp32): in bf16 the dK/dV kernel splits P into hi = bf16(P) and lo =
// bf16(P - hi) and sums both products on the tensor cores, which carries P
// to ~16 mantissa bits (relative error ~2^-17 against fp32's 2^-24, where
// bf16 alone gives 2^-9); dO is bf16 there, so each product term is exact.
// The bf16 kernels take exponentials as exp2 of scores scaled by log2(e).
//
// What bounds them on an H100: operations. Per query/key pair the forward
// does 4·D operations, dQ 6·D and dK/dV 8·D (10·D on the tensor cores with
// dV's second pass, 12·D at d 128 where both of a block's warpgroups form
// Sᵀ), on O(S·D) bytes, so at S = 2048 their intensity is in
// the thousands of operations per byte, far above the ~295 where bf16
// tensor cores stop waiting on memory. The least time is those operations
// over 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (fp32), with causal
// masking halving the pairs; beside them, one exponential per pair on the
// SFU (16 a clock per SM, about half the tensor-core time per pair at D 128).
//
// bf16 design (namespace sm90). A block is two consumer warpgroups of 64
// rows each plus one producer warpgroup. The forward and dQ give a block
// 128 query rows of one bh and walk the key tiles; dK/dV gives it the keys
// of one KV head (128 at d 64, each warpgroup holding dK and dV of its 64;
// 64 at d 128, one warpgroup computing dV and the other dK of the same
// keys, each recomputing Sᵀ, because dK and dV of 64 x 128 beside Sᵀ and
// dPᵀ leave wgmma too few registers) and walks every query tile of the
// group's kv_rep heads. Walked tiles are 64 rows. One warp of the producer
// decides which tiles some consumer needs, loads them by TMA into a ring of
// kStages shared-memory stages (a full and an empty mbarrier each), stages
// their per-row values (segment ids; lse and delta for dK/dV) with plain
// loads, and posts each consumer's pair state beside them, then an end
// mark; the rest of the producer warpgroup gives its registers to the
// consumers (setmaxnreg 40 / 232). Tiles live in shared memory as boxes of
// 64 bf16 columns (128-byte rows) in TMA's 128-byte swizzle, the layout
// wgmma's descriptors read: a d = 128 row is two boxes. The tensor maps are
// 3-D over (rows, S, D), built by the launcher with cuTensorMapEncodeTiled
// and passed as __grid_constant__ kernel parameters; TMA's zero fill past S
// replaces bound-checked loads. cuTensorMapEncodeTiled is a driver-API
// call: the launcher fetches it with cudaGetDriverEntryPoint, so the build
// links no -lcuda. Every product is a wgmma m64n64k16 (bf16 in, fp32
// accumulate): S = Q·Kᵀ and dP = dO·Vᵀ from shared memory (K-major),
// and the second products with A in registers, straight from the first
// product's accumulator (the two layouts agree): P·V in the forward, dS·K
// in dQ, Pᵀ_hi·dO + Pᵀ_lo·dO and dSᵀ·Q in dK/dV, their B operands (V, K,
// dO, Q) MN-major. The output and gradient accumulators (O, dQ, dK, dV)
// stay in registers across the whole walk and are written once. A row's
// softmax statistics live in the quad of lanes that holds it (two
// shuffles); exponentials are ex2.approx.ftz of log2(e)-scaled scores.
//
// Tile skipping, exact. A (64 rows, walked tile) pair is skipped when no
// pair in it is kept: past sq or kv_limit, above the causal diagonal, or,
// with segment ids, when the two tiles' id ranges are disjoint. The
// wrapper computes a [min, max] table of each row's ids per SEG_TILE (64)
// positions (kSegTile mirrors it; every tile here is one entry); a pair
// whose ranges meet in one shared id everywhere needs no mask at all, and
// only the others test each pair. The producer loads no tile that no
// consumer needs; a consumer passes on a loaded tile it needs nothing of.
// A skipped tile adds exactly what the masked tile did: p = 0, alpha = 1,
// dS = 0.
//
// fp32 (namespace fp32) keeps the first design: 8 warps per block, tiles of
// 32 in padded shared memory, FMA products, accumulators in shared memory.
// wgmma takes no fp32 input, and TF32 would change the numerics; no main
// path runs fp32 flash.
//
// What the bf16 design leaves on the table: a consumer waits for each
// product before it goes on (the two consumer warpgroups interleave; a
// software pipeline that kept the next tile's S in flight during the
// softmax ran slower here, ptxas serialising its wgmmas for registers),
// blocks are not persistent (one block an SM, so at S 512 a block's
// prologue and epilogue are a large share), and the epilogue writes from
// registers without staging.

#include <climits>
#include <cstring>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // same fill as the Pallas kernels

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* o0;  // out / dq / dk
  void* o1;  // dv
  float* lse_out;
  const int* seg_q;  // nullptr: no segment ids
  const int* seg_k;
  const void* q_range;  // bf16 with segment ids: their tile-range tables
  const void* k_range;
  int bh, sq, sk, kv_rep, causal, causal_offset, kv_limit, seg_div;
  float scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// fp32: FMA tile products in shared memory (wgmma takes no fp32 input, and
// TF32 would change the numerics). One block of 8 warps per (BH row, query
// tile) for the forward and dQ, walking the key tiles; one block per (KV
// head, key tile) for dK/dV, walking its group's query heads and tiles.
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// Tile sizes and padded leading dimensions (in elements); the padding keeps
// 16-byte row alignment and moves consecutive rows to other banks.
template <int D> struct Cfg {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int LDT = D + 4;   // q/k/v/dO tiles
  static constexpr int LDP = BK + 4;  // P and dS
  static constexpr int LDS = BK + 4;  // scores
  static constexpr int LDO = D + 4;   // accumulators
  static constexpr size_t kQ = align128(sizeof(float) * BQ * LDT);
  static constexpr size_t kK = align128(sizeof(float) * BK * LDT);
  static constexpr size_t kS = align128(sizeof(float) * BQ * LDS);
  static constexpr size_t kP = align128(sizeof(float) * BQ * LDP);
  static constexpr size_t kOq = align128(sizeof(float) * BQ * LDO);
  static constexpr size_t kOk = align128(sizeof(float) * BK * LDO);
  static constexpr size_t kRow = align128(sizeof(float) * BQ);
  static constexpr size_t kSegQ = align128(sizeof(int) * BQ);
  static constexpr size_t kSegK = align128(sizeof(int) * BK);
  // shared memory of each kernel, in the order the kernels carve it
  static constexpr size_t kFwd =
      kQ + 2 * kK + kS + kP + kOq + 3 * kRow + kSegQ + kSegK;
  static constexpr size_t kDq =
      2 * kQ + 2 * kK + 2 * kS + kP + kOq + 2 * kRow + kSegQ + kSegK;
  static constexpr size_t kDkv =
      2 * kK + 2 * kQ + 2 * kS + 2 * kP + 2 * kOk + 2 * kRow + kSegQ + kSegK;
};

struct Carve {
  unsigned char* p;
  template <typename U> __device__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

// C (M x N, shared memory, leading dim ldc) = A·B, or += when acc, for A
// (M x K) and B (K x N) in shared memory:
//   A(i, k) = A_COL ? a[k * lda + i] : a[i * lda + k]
//   B(k, j) = B_COL ? b[j * ldb + k] : b[k * ldb + j]
// Called by every thread of the block, one thread per 4x4 output tile; no
// barrier inside.
template <int M, int N, int K, bool A_COL, bool B_COL>
__device__ __forceinline__ void mm(float* c, int ldc, const float* a, int lda,
                                   const float* b, int ldb, bool acc) {
  constexpr int TN = N / 4;
  for (int t = threadIdx.x; t < (M / 4) * TN; t += kThreads) {
    const int i0 = (t / TN) * 4;
    const int j0 = (t % TN) * 4;
    float r[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = acc ? c[(i0 + i) * ldc + j0 + j] : 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = A_COL ? a[k * lda + i0 + i] : a[(i0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = B_COL ? b[(j0 + j) * ldb + k] : b[k * ldb + j0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] = fmaf(av[i], bv[j], r[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[(i0 + i) * ldc + j0 + j] = r[i][j];
  }
}

// rows row0 .. row0+rows-1 of a (n_rows, D) matrix into shared memory with
// leading dim ld, 16 bytes a thread; rows at or past n_rows become zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int row0, int n_rows, int rows) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * D +
                                             c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// per-row fp32 values (lse or delta) of rows row0 .. row0+rows-1; 0 past n
__device__ __forceinline__ void load_row_vals(float* dst, const float* src,
                                              int row0, int n, int rows) {
  for (int i = threadIdx.x; i < rows; i += kThreads)
    dst[i] = row0 + i < n ? src[row0 + i] : 0.f;
}

// segment ids of positions pos0 .. pos0+n-1 of bh's segment row (seg_div
// as in the header); 0 past the end
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int bh,
                                         int seg_div, int len, int pos0,
                                         int n) {
  const int* src = seg + (int64_t)(bh / seg_div) * len;
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = pos0 + i < len ? src[pos0 + i] : 0;
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

// SEG: the launch has segment ids, staged per tile in seg_r (the rows) and
// seg_c (the columns); without them the term compiles away
template <bool SEG>
__device__ __forceinline__ bool keep(int row, int col, int sq, int kv_limit,
                                     int causal, int causal_offset,
                                     const int* seg_r, const int* seg_c) {
  return row < sq && col < kv_limit &&
         (!causal || row + causal_offset >= col) && (!SEG || *seg_r == *seg_c);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Forward: grid (query tiles, BH); out (BH, sq, D), lse (BH, sq)
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, int sq, int sk, int kv_rep, int causal,
    int causal_offset, int kv_limit, int seg_div, float scale) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* qs = cv.take<float>(C::kQ);
  float* ks = cv.take<float>(C::kK);
  float* vs = cv.take<float>(C::kK);
  float* ss = cv.take<float>(C::kS);
  float* ps = cv.take<float>(C::kP);
  float* os = cv.take<float>(C::kOq);
  float* m_s = cv.take<float>(C::kRow);
  float* l_s = cv.take<float>(C::kRow);
  int* sq_s = cv.take<int>(C::kSegQ);
  int* sk_s = cv.take<int>(C::kSegK);

  // the longest causal rows first: the last query tile walks the most keys
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const float* kg = k + (int64_t)(bh / kv_rep) * sk * D;
  const float* vg = v + (int64_t)(bh / kv_rep) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_rows<D>(qs, C::LDT, q + (int64_t)bh * sq * D, q0, sq, BQ);
  if constexpr (SEG) load_seg(sq_s, seg_q, bh, seg_div, sq, q0, BQ);
  zero(os, BQ * C::LDO);
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  int k_end = kv_limit;
  if (causal) k_end = min(k_end, q0 + BQ + causal_offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    load_rows<D>(ks, C::LDT, kg, k0, sk, BK);
    load_rows<D>(vs, C::LDT, vg, k0, sk, BK);
    if constexpr (SEG) load_seg(sk_s, seg_k, bh, seg_div, sk, k0, BK);
    __syncthreads();
    mm<BQ, BK, D, false, true>(ss, C::LDS, qs, C::LDT, ks, C::LDT, false);
    __syncthreads();
    for (int r = warp; r < BQ; r += kWarps) {
      const int row = q0 + r;
      float sv[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const int c = lane + 32 * t;
        const bool kp = keep<SEG>(row, k0 + c, sq, kv_limit, causal,
                                  causal_offset, sq_s + r, sk_s + c);
        sv[t] = kp ? ss[r * C::LDS + c] * scale : kNegInf;
        mx = fmaxf(mx, sv[t]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const int c = lane + 32 * t;
        const bool kp = keep<SEG>(row, k0 + c, sq, kv_limit, causal,
                                  causal_offset, sq_s + r, sk_s + c);
        const float p = kp ? expf(sv[t] - m_new) : 0.f;
        ps[r * C::LDP + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < D; c += 32) os[r * C::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    mm<BQ, D, BK, false, false>(os, C::LDO, ps, C::LDP, vs, C::LDT, true);
    __syncthreads();
  }

  for (int r = warp; r < BQ; r += kWarps) {
    const int row = q0 + r;
    if (row >= sq) continue;
    const float l = l_s[r];
    const float safe_l = l == 0.f ? 1.f : l;
    float* o = out + ((int64_t)bh * sq + row) * D;
    for (int c = lane; c < D; c += 32) o[c] = os[r * C::LDO + c] / safe_l;
    if (lane == 0) lse[(int64_t)bh * sq + row] = m_s[r] + logf(safe_l);
  }
}

// dQ: grid (query tiles, BH); dq (BH, sq, D)
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, int sq, int sk, int kv_rep, int causal,
    int causal_offset, int kv_limit, int seg_div, float scale) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* qs = cv.take<float>(C::kQ);
  float* dos = cv.take<float>(C::kQ);
  float* ks = cv.take<float>(C::kK);
  float* vs = cv.take<float>(C::kK);
  float* ss = cv.take<float>(C::kS);
  float* dps = cv.take<float>(C::kS);
  float* dss = cv.take<float>(C::kP);
  float* acc = cv.take<float>(C::kOq);
  float* lse_s = cv.take<float>(C::kRow);
  float* delta_s = cv.take<float>(C::kRow);
  int* sq_s = cv.take<int>(C::kSegQ);
  int* sk_s = cv.take<int>(C::kSegK);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const float* kg = k + (int64_t)(bh / kv_rep) * sk * D;
  const float* vg = v + (int64_t)(bh / kv_rep) * sk * D;

  load_rows<D>(qs, C::LDT, q + (int64_t)bh * sq * D, q0, sq, BQ);
  load_rows<D>(dos, C::LDT, dout + (int64_t)bh * sq * D, q0, sq, BQ);
  load_row_vals(lse_s, lse + (int64_t)bh * sq, q0, sq, BQ);
  load_row_vals(delta_s, delta + (int64_t)bh * sq, q0, sq, BQ);
  if constexpr (SEG) load_seg(sq_s, seg_q, bh, seg_div, sq, q0, BQ);
  zero(acc, BQ * C::LDO);
  int k_end = kv_limit;
  if (causal) k_end = min(k_end, q0 + BQ + causal_offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    load_rows<D>(ks, C::LDT, kg, k0, sk, BK);
    load_rows<D>(vs, C::LDT, vg, k0, sk, BK);
    if constexpr (SEG) load_seg(sk_s, seg_k, bh, seg_div, sk, k0, BK);
    __syncthreads();
    mm<BQ, BK, D, false, true>(ss, C::LDS, qs, C::LDT, ks, C::LDT, false);
    mm<BQ, BK, D, false, true>(dps, C::LDS, dos, C::LDT, vs, C::LDT, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const bool kp = keep<SEG>(q0 + r, k0 + c, sq, kv_limit, causal,
                                causal_offset, sq_s + r, sk_s + c);
      const float p = kp ? expf(ss[r * C::LDS + c] * scale - lse_s[r]) : 0.f;
      dss[r * C::LDP + c] = p * (dps[r * C::LDS + c] - delta_s[r]);
    }
    __syncthreads();
    mm<BQ, D, BK, false, false>(acc, C::LDO, dss, C::LDP, ks, C::LDT, true);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < sq)
      dq[((int64_t)bh * sq + q0 + r) * D + c] = acc[r * C::LDO + c] * scale;
  }
}

// dK/dV: grid (key tiles, BH / kv_rep); dk, dv (BH / kv_rep, sk, D)
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, int sq,
    int sk, int kv_rep, int causal, int causal_offset, int kv_limit,
    int seg_div, float scale) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* ks = cv.take<float>(C::kK);
  float* vs = cv.take<float>(C::kK);
  float* qs = cv.take<float>(C::kQ);
  float* dos = cv.take<float>(C::kQ);
  float* ss = cv.take<float>(C::kS);
  float* dps = cv.take<float>(C::kS);
  float* ps = cv.take<float>(C::kP);
  float* dss = cv.take<float>(C::kP);
  float* dk_acc = cv.take<float>(C::kOk);
  float* dv_acc = cv.take<float>(C::kOk);
  float* lse_s = cv.take<float>(C::kRow);
  float* delta_s = cv.take<float>(C::kRow);
  int* sq_s = cv.take<int>(C::kSegQ);
  int* sk_s = cv.take<int>(C::kSegK);

  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  load_rows<D>(ks, C::LDT, k + (int64_t)kvh * sk * D, k0, sk, BK);
  load_rows<D>(vs, C::LDT, v + (int64_t)kvh * sk * D, k0, sk, BK);
  zero(dk_acc, BK * C::LDO);
  zero(dv_acc, BK * C::LDO);
  const int n_qt = (sq + BQ - 1) / BQ;

  for (int rep = 0; k0 < kv_limit && rep < kv_rep; ++rep) {
    const int bh = kvh * kv_rep + rep;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (causal && q0 + BQ + causal_offset <= k0) continue;
      __syncthreads();  // the previous tile's products are done
      load_rows<D>(qs, C::LDT, q + (int64_t)bh * sq * D, q0, sq, BQ);
      load_rows<D>(dos, C::LDT, dout + (int64_t)bh * sq * D, q0, sq, BQ);
      load_row_vals(lse_s, lse + (int64_t)bh * sq, q0, sq, BQ);
      load_row_vals(delta_s, delta + (int64_t)bh * sq, q0, sq, BQ);
      // the key tile's ids follow bh's segment row, so they load per head
      if constexpr (SEG) load_seg(sq_s, seg_q, bh, seg_div, sq, q0, BQ);
      if constexpr (SEG) load_seg(sk_s, seg_k, bh, seg_div, sk, k0, BK);
      __syncthreads();
      mm<BQ, BK, D, false, true>(ss, C::LDS, qs, C::LDT, ks, C::LDT, false);
      mm<BQ, BK, D, false, true>(dps, C::LDS, dos, C::LDT, vs, C::LDT, false);
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
        const int r = i / BK, c = i % BK;
        const bool kp = keep<SEG>(q0 + r, k0 + c, sq, kv_limit, causal,
                                  causal_offset, sq_s + r, sk_s + c);
        const float p = kp ? expf(ss[r * C::LDS + c] * scale - lse_s[r]) : 0.f;
        ps[r * C::LDP + c] = p;
        dss[r * C::LDP + c] = p * (dps[r * C::LDS + c] - delta_s[r]);
      }
      __syncthreads();
      mm<BK, D, BQ, true, false>(dv_acc, C::LDO, ps, C::LDP, dos, C::LDT, true);
      mm<BK, D, BQ, true, false>(dk_acc, C::LDO, dss, C::LDP, qs, C::LDT, true);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r < sk) {
      const int64_t o = ((int64_t)kvh * sk + k0 + r) * D + c;
      dk[o] = dk_acc[r * C::LDO + c] * scale;
      dv[o] = dv_acc[r * C::LDO + c];
    }
  }
}

}  // namespace fp32

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA-fed rings of tiles, wgmma, accumulators in registers
// (the building blocks are csrc/sm90.cuh's)
// ---------------------------------------------------------------------------
namespace sm90 {

constexpr int kSegTile = 64;   // SEG_TILE of ops/flash_attention.py
constexpr int kRows = 64;      // rows of one consumer warpgroup (wgmma's M)
constexpr int kTile = 64;      // rows of one walked tile (keys or queries)
constexpr int kConsumers = 2;  // consumer warpgroups per block
constexpr int kBlockRows = kRows * kConsumers;    // query rows of a block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kStages = 2;     // walked tiles in flight
// dK/dV at d 128 splits the work of 64 keys over the two warpgroups (dV in
// one, dK in the other, each recomputing S): dK and dV of 64 x 128 beside
// Sᵀ and dPᵀ in one warpgroup leave wgmma too few registers
template <int D> constexpr bool kDkvSplit = D == 128;
template <int D> constexpr int kDkvKeys = kDkvSplit<D> ? kRows : kBlockRows;
// the full barrier of a stage: the producer's TMA bytes (or its end mark)
// and one arrival from each lane of its warp, which stages the tile's
// per-row values and its TileInfo first
constexpr int kFullArrivals = 1 + 32;
constexpr int kProducerRegs = 40;   // 128·40 + 256·232 <= 65536
constexpr int kConsumerRegs = 232;

static_assert(kRows == kSegTile && kTile == kSegTile,
              "a segment range covers exactly one tile");

// pair states of a (rows, walked tile) pair: none kept, some, all
enum : int { kNone = 0, kSome = 1, kAll = 2 };

// what the producer tells the consumers about a stage: the walked tile's
// first position (-1: the walk is over), its query head (dK/dV) and each
// consumer warpgroup's pair state
struct TileInfo {
  int pos, bh;
  int state[kConsumers];
};

struct Params {
  // (rows, S, D) bf16 boxes of 64 columns, 128-byte swizzled
  CUtensorMap q, k, v, dout;
  bf16* o0;  // out / dq / dk
  bf16* o1;  // dv
  float* lse_out;
  const float* lse;
  const float* delta;
  const int* seg_q;
  const int* seg_k;
  const int2* q_range;  // (R, ceil(sq / kSegTile)) [min, max] of the ids
  const int2* k_range;  // (R, ceil(sk / kSegTile))
  int sq, sk, kv_rep, causal, causal_offset, kv_limit, seg_div;
  float scale;
};

// --- the mask and the tile skips ---------------------------------------------

// the kept pairs of query rows [q_lo, q_lo + 63] and keys [k_lo, k_lo + 63]
// by position alone: past sq or kv_limit, or above the causal diagonal
__device__ __forceinline__ int span_state(const Params& p, int q_lo,
                                          int k_lo) {
  const int q_hi = q_lo + kTile - 1, k_hi = k_lo + kTile - 1;
  if (q_lo >= p.sq || k_lo >= p.kv_limit ||
      (p.causal && q_hi + p.causal_offset < k_lo))
    return kNone;
  if (q_hi < p.sq && k_hi < p.kv_limit &&
      (!p.causal || q_lo + p.causal_offset >= k_hi))
    return kAll;
  return kSome;
}

// [min, max] of segment row srow's ids over the tile at pos (the range
// table holds one entry per kSegTile positions); empty past the end
__device__ __forceinline__ int2 id_range(const int2* table, int srow, int len,
                                         int pos) {
  const int nt = (len + kSegTile - 1) / kSegTile;
  return pos < len ? __ldg(&table[(int64_t)srow * nt + pos / kSegTile])
                   : make_int2(INT_MAX, INT_MIN);
}

// the pair's state with its segment ids: disjoint id ranges keep no pair
// (every pair's ids differ), one shared id everywhere keeps them all
__device__ __forceinline__ int with_ids(int st, int2 q, int2 k) {
  if (q.y < k.x || k.y < q.x) return kNone;
  return q.x == q.y && k.x == k.y && q.x == k.x ? st : min(st, kSome);
}

// one pair of a tile in state kSome
template <bool SEG>
__device__ __forceinline__ bool keep(const Params& p, int qi, int kj, int id_q,
                                     int id_k) {
  return qi < p.sq && kj < p.kv_limit &&
         (!p.causal || qi + p.causal_offset >= kj) && (!SEG || id_q == id_k);
}

// --- forward -----------------------------------------------------------------

template <int D> struct FwdSmem {
  static constexpr int NB = D / kBoxCols;
  Box<kRows> q[kConsumers][NB];
  Box<kTile> k[kStages][NB];
  Box<kTile> v[kStages][NB];
  alignas(128) int seg_k[kStages][kTile];
  TileInfo info[kStages];
  uint64_t full[kStages], empty[kStages], ready;
};

template <int D, bool SEG>
__device__ __forceinline__ void fwd_consumer(const Params& p, FwdSmem<D>& sm,
                                             int bh, int srow, int q0,
                                             int wg) {
  constexpr int NB = D / kBoxCols, NS = kTile / 2;
  const int t = threadIdx.x & 127, lane = t & 31;
  const int row0 = q0 + wg * kRows + (t >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  int id[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < p.sq)
        id[h] = p.seg_q[(int64_t)srow * p.sq + row0 + 8 * h];
  }
  const float sl2 = p.scale * kLog2e;  // scores in log2 units
  float o[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  bar_wait(&sm.ready, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    bar_wait(&sm.full[stage], phase);
    const int k0 = sm.info[stage].pos, state = sm.info[stage].state[wg];
    if (k0 < 0) break;
    if (state != kNone) {
      float s[NS];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(s, desc_k(sm.q[wg], kk), desc_k(sm.k[stage], kk), kk);
      wg_commit();
      wg_wait0();
      pin(s);
      // mask, scale, row max (a row lives in one quad of lanes)
      uint32_t kept = ~0u;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i >> 1) & 1;
        float x = s[i] * sl2;
        if (state == kSome) {
          const int c = 8 * (i >> 2) + col0 + (i & 1);
          if (!keep<SEG>(p, row0 + 8 * h, k0 + c, id[h],
                         SEG ? sm.seg_k[stage][c] : 0)) {
            x = kNegInf;
            kept &= ~(1u << i);
          }
        }
        s[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = exp2_ftz(m[h] - m_new);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i >> 1) & 1;
        const float pr = (kept >> i) & 1 ? exp2_ftz(s[i] - m[h]) : 0.f;
        s[i] = pr;
        sum[h] += pr;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[b][i] *= alpha[(i >> 1) & 1];
      // O += bf16(P)·V, P from the registers
      uint32_t pa[kTile / 16][4];
      to_a(s, pa);
#pragma unroll
      for (int b = 0; b < NB; ++b) pin(o[b]);
      wg_fence();
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          mma_rs_n64(o[b], pa[kk], desc_mn(sm.v[stage][b], kk));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int b = 0; b < NB; ++b) pin(o[b]);
      pin(pa);
    }
    bar_arrive(&sm.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.sq) continue;
    const float safe_l = l[h] == 0.f ? 1.f : l[h];
    bf16* out = p.o0 + ((int64_t)bh * p.sq + row) * D;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = 4 * c + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(out + b * kBoxCols + 8 * c + col0) =
            __floats2bfloat162_rn(o[b][i] / safe_l, o[b][i + 1] / safe_l);
      }
    if ((lane & 3) == 0)
      p.lse_out[(int64_t)bh * p.sq + row] =
          l[h] == 0.f ? kNegInf : m[h] * kLn2 + logf(l[h]);
  }
}

// The producer of the forward and dQ: one warp walks the key tiles that
// some consumer needs (causal and kv_limit bound the walk, the states skip
// inside it), loads K and V by TMA and stages the keys' segment ids, then
// posts the end mark. Lane 0 issues the copies.
template <int D, bool SEG, typename Smem>
__device__ __forceinline__ void walk_keys(const Params& p, Smem& sm, int kvh,
                                          int srow, int q0, int n_kt) {
  constexpr int NB = D / kBoxCols;
  const int lane = threadIdx.x & 31;
  int2 qr[kConsumers];
#pragma unroll
  for (int w = 0; w < kConsumers; ++w)
    qr[w] = SEG ? id_range(p.q_range, srow, p.sq, q0 + w * kRows)
                : make_int2(0, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt <= n_kt; ++kt) {
    TileInfo ti{kt < n_kt ? kt * kTile : -1, 0, {kNone, kNone}};
    bool post = ti.pos < 0;
    if (!post) {
      const int2 kr = SEG ? id_range(p.k_range, srow, p.sk, ti.pos)
                          : make_int2(0, 0);
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) {
        int st = span_state(p, q0 + w * kRows, ti.pos);
        if (SEG && st != kNone) st = with_ids(st, qr[w], kr);
        ti.state[w] = st;
        post |= st != kNone;
      }
    }
    if (!post) continue;
    bar_wait(&sm.empty[stage], phase ^ 1);
    if (lane == 0) {
      sm.info[stage] = ti;
      if (ti.pos >= 0) {
        bar_expect_tx(&sm.full[stage], sizeof(sm.k[0]) + sizeof(sm.v[0]));
        for (int b = 0; b < NB; ++b) {
          tma_3d(&sm.k[stage][b], &p.k, &sm.full[stage], b * kBoxCols,
                 ti.pos, kvh);
          tma_3d(&sm.v[stage][b], &p.v, &sm.full[stage], b * kBoxCols,
                 ti.pos, kvh);
        }
      } else {
        bar_arrive(&sm.full[stage]);
      }
    }
    if (SEG && ti.pos >= 0)
      for (int i = lane; i < kTile; i += 32) {
        const int pos = ti.pos + i;
        sm.seg_k[stage][i] =
            pos < p.sk ? p.seg_k[(int64_t)srow * p.sk + pos] : 0;
      }
    bar_arrive(&sm.full[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <typename Smem>
__device__ __forceinline__ void init_barriers(Smem& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], kFullArrivals);
      bar_init(&sm.empty[s], kConsumers * 128);
    }
    bar_init(&sm.ready, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// the keys a block of query rows q0 .. q0 + kBlockRows - 1 may attend
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int k_end = p.kv_limit;
  if (p.causal) k_end = min(k_end, q0 + kBlockRows + p.causal_offset);
  return k_end > 0 ? (k_end + kTile - 1) / kTile : 0;
}

// grid (BH, query tiles of kBlockRows); out (BH, sq, D), lse (BH, sq)
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_fwd_kernel(const __grid_constant__ Params p) {
  constexpr int NB = D / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FwdSmem<D>*>(align1024(smem_raw));
  const int bh = blockIdx.x;
  // the longest causal rows first: the last query tile walks the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int srow = bh / p.seg_div;
  init_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    if (threadIdx.x == kConsumers * 128) {
      bar_expect_tx(&sm.ready, sizeof(sm.q));
      for (int w = 0; w < kConsumers; ++w)
        for (int b = 0; b < NB; ++b)
          tma_3d(&sm.q[w][b], &p.q, &sm.ready, b * kBoxCols, q0 + w * kRows,
                 bh);
    }
    walk_keys<D, SEG>(p, sm, bh / p.kv_rep, srow, q0, key_tiles(p, q0));
  } else {
    regs_alloc<kConsumerRegs>();
    fwd_consumer<D, SEG>(p, sm, bh, srow, q0, wg);
  }
}

// --- dQ ----------------------------------------------------------------------

template <int D> struct DqSmem {
  static constexpr int NB = D / kBoxCols;
  Box<kRows> q[kConsumers][NB];
  Box<kRows> dout[kConsumers][NB];
  Box<kTile> k[kStages][NB];
  Box<kTile> v[kStages][NB];
  alignas(128) int seg_k[kStages][kTile];
  TileInfo info[kStages];
  uint64_t full[kStages], empty[kStages], ready;
};

template <int D, bool SEG>
__device__ __forceinline__ void dq_consumer(const Params& p, DqSmem<D>& sm,
                                            int bh, int srow, int q0, int wg) {
  constexpr int NB = D / kBoxCols, NS = kTile / 2;
  const int t = threadIdx.x & 127, lane = t & 31;
  const int row0 = q0 + wg * kRows + (t >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  int id[2] = {0, 0};
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.sq) continue;
    lse2[h] = p.lse[(int64_t)bh * p.sq + row] * kLog2e;
    dlt[h] = p.delta[(int64_t)bh * p.sq + row];
    if constexpr (SEG) id[h] = p.seg_q[(int64_t)srow * p.sq + row];
  }
  const float sl2 = p.scale * kLog2e;
  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  bar_wait(&sm.ready, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    bar_wait(&sm.full[stage], phase);
    const int k0 = sm.info[stage].pos, state = sm.info[stage].state[wg];
    if (k0 < 0) break;
    if (state != kNone) {
      float s[NS], dp[NS];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(s, desc_k(sm.q[wg], kk), desc_k(sm.k[stage], kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(dp, desc_k(sm.dout[wg], kk), desc_k(sm.v[stage], kk), kk);
      wg_commit();
      wg_wait0();
      pin(s);
      pin(dp);
      // dS = P·(dP - delta), P = exp(S·scale - lse) or exactly 0
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + col0 + (i & 1);
        const bool kp = state == kAll ||
                        keep<SEG>(p, row0 + 8 * h, k0 + c, id[h],
                                  SEG ? sm.seg_k[stage][c] : 0);
        const float pr = kp ? exp2_ftz(s[i] * sl2 - lse2[h]) : 0.f;
        s[i] = pr * (dp[i] - dlt[h]);
      }
      // dQ += bf16(dS)·K, dS from the registers
      uint32_t da[kTile / 16][4];
      to_a(s, da);
#pragma unroll
      for (int b = 0; b < NB; ++b) pin(acc[b]);
      wg_fence();
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          mma_rs_n64(acc[b], da[kk], desc_mn(sm.k[stage][b], kk));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int b = 0; b < NB; ++b) pin(acc[b]);
      pin(da);
    }
    bar_arrive(&sm.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.sq) continue;
    bf16* dq = p.o0 + ((int64_t)bh * p.sq + row) * D;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = 4 * c + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dq + b * kBoxCols + 8 * c + col0) =
            __floats2bfloat162_rn(acc[b][i] * p.scale, acc[b][i + 1] * p.scale);
      }
  }
}

// grid (BH, query tiles of kBlockRows); dq (BH, sq, D)
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const __grid_constant__ Params p) {
  constexpr int NB = D / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<D>*>(align1024(smem_raw));
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int srow = bh / p.seg_div;
  init_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    if (threadIdx.x == kConsumers * 128) {
      bar_expect_tx(&sm.ready, sizeof(sm.q) + sizeof(sm.dout));
      for (int w = 0; w < kConsumers; ++w)
        for (int b = 0; b < NB; ++b) {
          tma_3d(&sm.q[w][b], &p.q, &sm.ready, b * kBoxCols, q0 + w * kRows,
                 bh);
          tma_3d(&sm.dout[w][b], &p.dout, &sm.ready, b * kBoxCols,
                 q0 + w * kRows, bh);
        }
    }
    walk_keys<D, SEG>(p, sm, bh / p.kv_rep, srow, q0, key_tiles(p, q0));
  } else {
    regs_alloc<kConsumerRegs>();
    dq_consumer<D, SEG>(p, sm, bh, srow, q0, wg);
  }
}

// --- dK/dV -------------------------------------------------------------------

template <int D> struct DkvSmem {
  static constexpr int NB = D / kBoxCols;
  static constexpr int KW = kDkvSplit<D> ? 1 : kConsumers;  // key groups
  Box<kRows> k[KW][NB];
  Box<kRows> v[KW][NB];
  Box<kTile> q[kStages][NB];
  Box<kTile> dout[kStages][NB];
  alignas(128) float lse[kStages][kTile];
  alignas(128) float delta[kStages][kTile];
  alignas(128) int seg_q[kStages][kTile];
  TileInfo info[kStages];
  uint64_t full[kStages], empty[kStages], ready;
};

// One consumer warpgroup of dK/dV: key rows k0 + 64·kw .. + 63, dK and/or
// dV of them (both, or one each in the split at d 128).
template <int D, bool SEG, bool DK, bool DV>
__device__ __forceinline__ void dkv_consumer(const Params& p, DkvSmem<D>& sm,
                                             int kvh, int k0, int wg, int kw) {
  constexpr int NB = D / kBoxCols, NS = kTile / 2;
  const int t = threadIdx.x & 127, lane = t & 31;
  const int krow0 = k0 + kw * kRows + (t >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float sl2 = p.scale * kLog2e;
  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[b][i] = dv[b][i] = 0.f;
  bar_wait(&sm.ready, 0);
  int stage = 0;
  uint32_t phase = 0;
  int id[2] = {0, 0}, id_bh = -1;
  for (;;) {
    bar_wait(&sm.full[stage], phase);
    const int q0 = sm.info[stage].pos, state = sm.info[stage].state[wg];
    if (q0 < 0) break;
    if (SEG && sm.info[stage].bh != id_bh) {
      // the key rows' ids follow the query head's segment row
      id_bh = sm.info[stage].bh;
      const int srow = id_bh / p.seg_div;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        id[h] = krow0 + 8 * h < p.sk
                    ? p.seg_k[(int64_t)srow * p.sk + krow0 + 8 * h]
                    : 0;
    }
    if (state != kNone) {
      // Sᵀ = K·Qᵀ (and dPᵀ = V·dOᵀ for dK): the keys are the rows
      float s[NS], dp[NS];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(s, desc_k(sm.k[kw], kk), desc_k(sm.q[stage], kk), kk);
      if constexpr (DK) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss_n64(dp, desc_k(sm.v[kw], kk), desc_k(sm.dout[stage], kk),
                     kk);
      }
      wg_commit();
      wg_wait0();
      pin(s);
      if constexpr (DK) pin(dp);
      // Pᵀ as a hi/lo pair of bf16 (P at ~16 bits for dV), bf16(dSᵀ)
      uint32_t ph[kTile / 16][4], pl[kTile / 16][4], da[kTile / 16][4];
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
        const int qc = 8 * c + col0;
        const float2 lse =
            *reinterpret_cast<const float2*>(&sm.lse[stage][qc]);
        float2 dlt = make_float2(0.f, 0.f);
        if constexpr (DK)
          dlt = *reinterpret_cast<const float2*>(&sm.delta[stage][qc]);
        int2 idq = make_int2(0, 0);
        if constexpr (SEG)
          idq = *reinterpret_cast<const int2*>(&sm.seg_q[stage][qc]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pr[2], ds[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = 4 * c + 2 * h + j;
            const bool kp =
                state == kAll || keep<SEG>(p, q0 + qc + j, krow0 + 8 * h,
                                           j ? idq.y : idq.x, id[h]);
            pr[j] = kp ? exp2_ftz(s[i] * sl2 - (j ? lse.y : lse.x) * kLog2e)
                       : 0.f;
            if constexpr (DK) ds[j] = pr[j] * (dp[i] - (j ? dlt.y : dlt.x));
          }
          const int kk = c >> 1, r = 2 * (c & 1) + h;
          if constexpr (DV) {
            const __nv_bfloat162 hi = __floats2bfloat162_rn(pr[0], pr[1]);
            ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
            pl[kk][r] = pack_bf16(pr[0] - __low2float(hi),
                                  pr[1] - __high2float(hi));
          }
          if constexpr (DK) da[kk][r] = pack_bf16(ds[0], ds[1]);
        }
      }
      // dV += Pᵀ_hi·dO + Pᵀ_lo·dO, dK += dSᵀ·Q
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if constexpr (DK) pin(dk[b]);
        if constexpr (DV) pin(dv[b]);
      }
      wg_fence();
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          if constexpr (DV) {
            mma_rs_n64(dv[b], ph[kk], desc_mn(sm.dout[stage][b], kk));
            mma_rs_n64(dv[b], pl[kk], desc_mn(sm.dout[stage][b], kk));
          }
          if constexpr (DK)
            mma_rs_n64(dk[b], da[kk], desc_mn(sm.q[stage][b], kk));
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if constexpr (DK) pin(dk[b]);
        if constexpr (DV) pin(dv[b]);
      }
      if constexpr (DV) {
        pin(ph);
        pin(pl);
      }
      if constexpr (DK) pin(da);
    }
    bar_arrive(&sm.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int krow = krow0 + 8 * h;
    if (krow >= p.sk) continue;
    const int64_t o = ((int64_t)kvh * p.sk + krow) * D;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = 4 * c + 2 * h, col = b * kBoxCols + 8 * c + col0;
        if constexpr (DK)
          *reinterpret_cast<__nv_bfloat162*>(p.o0 + o + col) =
              __floats2bfloat162_rn(dk[b][i] * p.scale,
                                    dk[b][i + 1] * p.scale);
        if constexpr (DV)
          *reinterpret_cast<__nv_bfloat162*>(p.o1 + o + col) =
              __floats2bfloat162_rn(dv[b][i], dv[b][i + 1]);
      }
  }
}

// grid (BH / kv_rep, key tiles of kDkvKeys); dk, dv (BH / kv_rep, sk, D).
// The producer walks every query tile of the KV head's kv_rep query heads.
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkv_kernel(const __grid_constant__ Params p) {
  using Smem = DkvSmem<D>;
  constexpr int NB = Smem::NB, KW = Smem::KW;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int kvh = blockIdx.x;
  // the first key tiles have the most causal rows: they go first
  const int k0 = blockIdx.y * kDkvKeys<D>;
  init_barriers(sm);
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    if (lane == 0) {
      bar_expect_tx(&sm.ready, sizeof(sm.k) + sizeof(sm.v));
      for (int w = 0; w < KW; ++w)
        for (int b = 0; b < NB; ++b) {
          tma_3d(&sm.k[w][b], &p.k, &sm.ready, b * kBoxCols, k0 + w * kRows,
                 kvh);
          tma_3d(&sm.v[w][b], &p.v, &sm.ready, b * kBoxCols, k0 + w * kRows,
                 kvh);
        }
    }
    const int n_qt = (p.sq + kTile - 1) / kTile, n = n_qt * p.kv_rep;
    int2 kr[kConsumers] = {make_int2(0, 0), make_int2(0, 0)};
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it <= n; ++it) {
      const int bh = kvh * p.kv_rep + it / n_qt, srow = bh / p.seg_div;
      TileInfo ti{it < n ? (it % n_qt) * kTile : -1, bh, {kNone, kNone}};
      bool post = ti.pos < 0;
      if (!post) {
        if (SEG && ti.pos == 0)
          for (int w = 0; w < kConsumers; ++w)
            kr[w] = id_range(p.k_range, srow, p.sk,
                             k0 + (KW == 1 ? 0 : w) * kRows);
        const int2 qr = SEG ? id_range(p.q_range, srow, p.sq, ti.pos)
                            : make_int2(0, 0);
#pragma unroll
        for (int w = 0; w < kConsumers; ++w) {
          int st = span_state(p, ti.pos, k0 + (KW == 1 ? 0 : w) * kRows);
          if (SEG && st != kNone) st = with_ids(st, qr, kr[w]);
          ti.state[w] = st;
          post |= st != kNone;
        }
      }
      if (!post) continue;
      bar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) {
        sm.info[stage] = ti;
        if (ti.pos >= 0) {
          bar_expect_tx(&sm.full[stage], sizeof(sm.q[0]) + sizeof(sm.dout[0]));
          for (int b = 0; b < NB; ++b) {
            tma_3d(&sm.q[stage][b], &p.q, &sm.full[stage], b * kBoxCols,
                   ti.pos, bh);
            tma_3d(&sm.dout[stage][b], &p.dout, &sm.full[stage],
                   b * kBoxCols, ti.pos, bh);
          }
        } else {
          bar_arrive(&sm.full[stage]);
        }
      }
      if (ti.pos >= 0)
        for (int i = lane; i < kTile; i += 32) {
          const int qi = ti.pos + i;
          const bool in = qi < p.sq;
          sm.lse[stage][i] = in ? p.lse[(int64_t)bh * p.sq + qi] : 0.f;
          sm.delta[stage][i] = in ? p.delta[(int64_t)bh * p.sq + qi] : 0.f;
          if constexpr (SEG)
            sm.seg_q[stage][i] = in ? p.seg_q[(int64_t)srow * p.sq + qi] : 0;
        }
      bar_arrive(&sm.full[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    if constexpr (kDkvSplit<D>) {
      if (wg == 0) dkv_consumer<D, SEG, false, true>(p, sm, kvh, k0, wg, 0);
      else dkv_consumer<D, SEG, true, false>(p, sm, kvh, k0, wg, 0);
    } else {
      dkv_consumer<D, SEG, true, true>(p, sm, kvh, k0, wg, wg);
    }
  }
}

// --- launchers ---------------------------------------------------------------

// (rows, s, d) bf16 in boxes of box_rows x 64 columns, 128-byte swizzled;
// rows past s read as zeros
bool map_rows(CUtensorMap* m, const void* base, int rows, int s, int d,
              int box_rows) {
  return encode_map<bf16, 3>(
      m, base, {(uint64_t)d, (uint64_t)s, (uint64_t)rows},
      {(uint64_t)d * 2, (uint64_t)s * d * 2},
      {(uint32_t)kBoxCols, (uint32_t)box_rows, 1u});
}

Params base_params(const Args& a) {
  Params p;
  memset(&p, 0, sizeof(p));
  p.o0 = static_cast<bf16*>(a.o0);
  p.o1 = static_cast<bf16*>(a.o1);
  p.lse_out = a.lse_out;
  p.lse = a.lse_in;
  p.delta = a.delta;
  p.seg_q = a.seg_q;
  p.seg_k = a.seg_k;
  p.q_range = static_cast<const int2*>(a.q_range);
  p.k_range = static_cast<const int2*>(a.k_range);
  p.sq = a.sq;
  p.sk = a.sk;
  p.kv_rep = a.kv_rep;
  p.causal = a.causal;
  p.causal_offset = a.causal_offset;
  p.kv_limit = a.kv_limit;
  p.seg_div = a.seg_div;
  p.scale = a.scale;
  return p;
}

template <typename Smem, typename K>
cudaError_t launch(K kernel, dim3 grid, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem) + 1024;  // + the 1024-byte alignment
  static_assert(smem <= 232448, "shared memory of one block");
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_fwd(const Args& a) {
  Params p = base_params(a);
  const int kv_rows = a.bh / a.kv_rep;
  if (!map_rows(&p.q, a.q, a.bh, a.sq, D, kRows) ||
      !map_rows(&p.k, a.k, kv_rows, a.sk, D, kTile) ||
      !map_rows(&p.v, a.v, kv_rows, a.sk, D, kTile))
    return cudaErrorInvalidValue;
  const dim3 grid(a.bh, (a.sq + kBlockRows - 1) / kBlockRows);
  return launch<FwdSmem<D>>(flash_attention_fwd_kernel<D, SEG>, grid, p,
                            a.stream);
}

template <int D, bool SEG>
cudaError_t launch_dq(const Args& a) {
  Params p = base_params(a);
  const int kv_rows = a.bh / a.kv_rep;
  if (!map_rows(&p.q, a.q, a.bh, a.sq, D, kRows) ||
      !map_rows(&p.dout, a.dout, a.bh, a.sq, D, kRows) ||
      !map_rows(&p.k, a.k, kv_rows, a.sk, D, kTile) ||
      !map_rows(&p.v, a.v, kv_rows, a.sk, D, kTile))
    return cudaErrorInvalidValue;
  const dim3 grid(a.bh, (a.sq + kBlockRows - 1) / kBlockRows);
  return launch<DqSmem<D>>(flash_attention_bwd_dq_kernel<D, SEG>, grid, p,
                           a.stream);
}

template <int D, bool SEG>
cudaError_t launch_dkv(const Args& a) {
  Params p = base_params(a);
  const int kv_rows = a.bh / a.kv_rep;
  if (!map_rows(&p.q, a.q, a.bh, a.sq, D, kTile) ||
      !map_rows(&p.dout, a.dout, a.bh, a.sq, D, kTile) ||
      !map_rows(&p.k, a.k, kv_rows, a.sk, D, kRows) ||
      !map_rows(&p.v, a.v, kv_rows, a.sk, D, kRows))
    return cudaErrorInvalidValue;
  const dim3 grid(kv_rows, (a.sk + kDkvKeys<D> - 1) / kDkvKeys<D>);
  return launch<DkvSmem<D>>(flash_attention_bwd_dkv_kernel<D, SEG>, grid, p,
                            a.stream);
}

}  // namespace sm90

namespace {

// fp32 launchers
namespace fp32 {

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, bool SEG>
cudaError_t launch_fwd(const Args& a) {
  using C = Cfg<D>;
  auto kernel = flash_attention_fwd_kernel<D, SEG>;
  cudaError_t e = set_smem(kernel, C::kFwd);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + C::BQ - 1) / C::BQ, a.bh);
  kernel<<<grid, kThreads, C::kFwd, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o0), a.lse_out,
      a.seg_q, a.seg_k, a.sq, a.sk, a.kv_rep, a.causal, a.causal_offset,
      a.kv_limit, a.seg_div, a.scale);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_dq(const Args& a) {
  using C = Cfg<D>;
  auto kernel = flash_attention_bwd_dq_kernel<D, SEG>;
  cudaError_t e = set_smem(kernel, C::kDq);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + C::BQ - 1) / C::BQ, a.bh);
  kernel<<<grid, kThreads, C::kDq, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse_in, a.delta, static_cast<float*>(a.o0), a.seg_q, a.seg_k, a.sq,
      a.sk, a.kv_rep, a.causal, a.causal_offset, a.kv_limit, a.seg_div,
      a.scale);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_dkv(const Args& a) {
  using C = Cfg<D>;
  auto kernel = flash_attention_bwd_dkv_kernel<D, SEG>;
  cudaError_t e = set_smem(kernel, C::kDkv);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sk + C::BK - 1) / C::BK, a.bh / a.kv_rep);
  kernel<<<grid, kThreads, C::kDkv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse_in, a.delta, static_cast<float*>(a.o0), static_cast<float*>(a.o1),
      a.seg_q, a.seg_k, a.sq, a.sk, a.kv_rep, a.causal, a.causal_offset,
      a.kv_limit, a.seg_div, a.scale);
  return cudaGetLastError();
}

}  // namespace fp32

enum class Which { kFwd, kDq, kDkv };

template <int D, bool SEG>
cudaError_t dispatch_fp32(Which w, const Args& a) {
  switch (w) {
    case Which::kFwd: return fp32::launch_fwd<D, SEG>(a);
    case Which::kDq: return fp32::launch_dq<D, SEG>(a);
    default: return fp32::launch_dkv<D, SEG>(a);
  }
}

template <int D, bool SEG>
cudaError_t dispatch_bf16(Which w, const Args& a) {
  switch (w) {
    case Which::kFwd: return sm90::launch_fwd<D, SEG>(a);
    case Which::kDq: return sm90::launch_dq<D, SEG>(a);
    default: return sm90::launch_dkv<D, SEG>(a);
  }
}

template <int D>
cudaError_t dispatch_dtype(Which w, int dtype, const Args& a) {
  const bool seg = a.seg_q != nullptr;
  if (dtype == 0)
    return seg ? dispatch_fp32<D, true>(w, a) : dispatch_fp32<D, false>(w, a);
  return seg ? dispatch_bf16<D, true>(w, a) : dispatch_bf16<D, false>(w, a);
}

// dtype: 0 = float32, 1 = bfloat16
int dispatch(Which w, int head_dim, int dtype, const Args& a) {
  // every output element is written only when there is a query and a key;
  // bf16 with segment ids needs their tile-range tables
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || a.kv_rep <= 0 ||
      a.bh % a.kv_rep != 0 || a.seg_div <= 0 ||
      (a.seg_q == nullptr) != (a.seg_k == nullptr) ||
      (dtype != 0 && dtype != 1) ||
      (dtype == 1 && a.seg_q && (!a.q_range || !a.k_range)))
    return (int)cudaErrorInvalidValue;
  if (head_dim == 64) return (int)dispatch_dtype<64>(w, dtype, a);
  if (head_dim == 128) return (int)dispatch_dtype<128>(w, dtype, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The positions per entry of the segment tile-range tables; the wrapper
// checks it against its own SEG_TILE before the first launch.
extern "C" int flash_attention_seg_tile() { return sm90::kSegTile; }

// Dynamic shared memory of a block of one kernel (which: 0 forward, 1 dQ,
// 2 dK/dV; dtype as below), for the smoke run's report; -1 if none.
extern "C" int flash_attention_smem_bytes(int which, int head_dim, int dtype) {
  using namespace sm90;
  constexpr int pad = 1024;  // the launchers' alignment slack
  const size_t bf16_64[3] = {sizeof(FwdSmem<64>) + pad,
                             sizeof(DqSmem<64>) + pad,
                             sizeof(DkvSmem<64>) + pad};
  const size_t bf16_128[3] = {sizeof(FwdSmem<128>) + pad,
                              sizeof(DqSmem<128>) + pad,
                              sizeof(DkvSmem<128>) + pad};
  const size_t fp32_64[3] = {fp32::Cfg<64>::kFwd, fp32::Cfg<64>::kDq,
                             fp32::Cfg<64>::kDkv};
  const size_t fp32_128[3] = {fp32::Cfg<128>::kFwd, fp32::Cfg<128>::kDq,
                              fp32::Cfg<128>::kDkv};
  if (which < 0 || which > 2 || (head_dim != 64 && head_dim != 128))
    return -1;
  const bool d64 = head_dim == 64;
  if (dtype == 1) return (int)(d64 ? bf16_64 : bf16_128)[which];
  if (dtype == 0) return (int)(d64 ? fp32_64 : fp32_128)[which];
  return -1;
}

// Each entry returns a cudaError_t (0 on success); the Python wrapper raises
// on anything else. kv_limit is the number of keys that may be attended
// (kv_valid clamped to sk, or sk). seg_q/seg_k are both null (no segment
// ids) or both int32 (R, sq) / (R, sk) with seg_div = bh / R (bh when R = 1
// is one row shared by every bh); with bf16 inputs q_range/k_range are then
// their (R, ceil(S / SEG_TILE), 2) int32 [min, max] tables (the fp32
// kernels read none).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* seg_q, const void* seg_k, const void* q_range,
    const void* k_range, int bh, int sq, int sk, int head_dim, int kv_rep,
    int dtype, int causal, int causal_offset, int kv_limit, int seg_div,
    float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr,
         static_cast<float*>(lse), static_cast<const int*>(seg_q),
         static_cast<const int*>(seg_k), q_range, k_range, bh, sq, sk,
         kv_rep, causal, causal_offset, kv_limit, seg_div, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(Which::kFwd, head_dim, dtype, a);
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* seg_q,
    const void* seg_k, const void* q_range, const void* k_range, int bh,
    int sq, int sk, int head_dim, int kv_rep, int dtype, int causal,
    int causal_offset, int kv_limit, int seg_div, float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr,
         static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
         q_range, k_range, bh, sq, sk, kv_rep, causal, causal_offset,
         kv_limit, seg_div, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Which::kDq, head_dim, dtype, a);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* seg_q,
    const void* seg_k, const void* q_range, const void* k_range, int bh,
    int sq, int sk, int head_dim, int kv_rep, int dtype, int causal,
    int causal_offset, int kv_limit, int seg_div, float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv, nullptr,
         static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
         q_range, k_range, bh, sq, sk, kv_rep, causal, causal_offset,
         kv_limit, seg_div, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Which::kDkv, head_dim, dtype, a);
}
