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
// row b / kv_rep (GQA without repeated KV). Scores are fp32; the mask keeps
// col < kv_limit and, when causal, row + causal_offset >= col; masked
// probabilities are exactly 0, so a row with nothing to attend gives out 0
// and lse -1e30. With segment ids (seg_q (R, sq) and seg_k (R, sk) int32,
// query row bh reading row bh / seg_div; seg_div = BH / R, or BH for one
// row shared by every bh), the mask also keeps seg_q[row] == seg_k[col] only:
// packed sequences attend within their own segment, and pads (-1 on the
// query side, -2 on the key side, set by the caller) attend nothing. Such a
// row's lse is -1e30, so the backward's exp(s - lse) overflows there; like
// every masked probability it is selected to 0, never multiplied by a mask. The forward keeps an online softmax and writes out (q's
// dtype) and the log-sum-exp (fp32). The backward takes the saved lse and
// delta = sum(dO * O) per row (computed by the caller) and recomputes
//   p = exp(s - lse), dp = dO·Vᵀ, ds = p·(dp - delta),
//   dQ = ds·K·scale, dV = pᵀ·dO, dK = dsᵀ·Q·scale,
// with dK/dV summed over each KV head's kv_rep query heads. As in the Pallas
// kernels, P is rounded to the input dtype before P·V in the forward, dS
// before dQ and dK, and dO before dP; every sum is fp32. dV is the one
// product the Pallas kernel takes with P in fp32 (its dO is cast to fp32):
// in bf16 the dK/dV kernel splits P into hi = bf16(P) and lo = bf16(P - hi)
// and sums both products on the tensor cores, which carries P to ~16
// mantissa bits (relative error ~2^-17 against fp32's 2^-24, where bf16
// alone gives 2^-9); dO is bf16 there, so each product term is exact.
//
// What bounds them on an H100: operations. Per query/key pair the forward
// does 4·D operations, dQ 6·D and dK/dV 8·D, on O(S·D) bytes, so at S = 2048
// their intensity is in the thousands of operations per byte, far above the
// ~295 where bf16 tensor cores stop waiting on memory. The least time is
// those operations over 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (fp32),
// with causal masking halving the pairs.
//
// Design (simple first). One block of 8 warps per (BH row, query tile) for
// the forward and for dQ, walking the key tiles in a loop (the Pallas grid's
// sequential j axis becomes that loop); one block per (KV head, key tile) for
// dK/dV, walking its group's query heads and their query tiles, so the GQA
// sum stays in the block and needs no atomics. Tiles are staged in shared
// memory with 16-byte loads; key tiles wholly above the causal diagonal or
// past kv_limit are skipped, as the Pallas `run` predicate skips them. The
// products are tile GEMMs in shared memory: bf16 on the tensor cores through
// WMMA (16x16x16, fp32 accumulate), fp32 with plain FMAs. The running
// output and gradient accumulators live in shared memory in fp32, so the
// softmax rescale is a plain elementwise pass. Segment ids are staged per
// tile in shared memory beside the tiles; the mask term costs two
// shared-memory reads and a compare per score. It is a template switch
// (SEG): the instantiations without segment ids carry none of it, since a
// run-time test cost the causal dQ kernel a fifth of its time.
// Key tiles whose segments meet none of the query tile's are not skipped:
// every tile inside the causal/kv_limit bounds is computed and masked.
//
// What this design leaves on the table: no wgmma, no TMA, no overlap of the
// next tile's loads with this tile's math, accumulators round-tripping
// through shared memory on every tile, one block per SM for the backward's
// shared-memory footprint, and the second dV pass of the bf16 dK/dV kernel
// (10·D tensor-core operations per pair where the work needs 8·D; an FMA
// dV with P in fp32 registers would avoid it). A FlashAttention-3-style
// redesign is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;  // same fill as the Pallas kernels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// Tile sizes and padded leading dimensions (in elements). The padding keeps
// 16-byte row alignment and moves consecutive rows to other banks; every
// WMMA pointer below stays 32-byte aligned with these strides.
template <typename T, int D> struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BQ = kBf16 ? 64 : 32;
  static constexpr int BK = kBf16 ? 64 : 32;
  static constexpr int PAD = kBf16 ? 8 : 4;
  static constexpr int LDT = D + PAD;   // q/k/v/dO tiles, T
  static constexpr int LDP = BK + PAD;  // P and dS, T
  static constexpr int LDS = BK + 4;    // scores, fp32
  static constexpr int LDO = D + 4;     // accumulators, fp32
  static constexpr size_t kQ = align128(sizeof(T) * BQ * LDT);
  static constexpr size_t kK = align128(sizeof(T) * BK * LDT);
  static constexpr size_t kS = align128(sizeof(float) * BQ * LDS);
  static constexpr size_t kP = align128(sizeof(T) * BQ * LDP);
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
  // dK/dV in bf16 keeps P's low part as a third P-sized tile
  static constexpr size_t kDkv = 2 * kK + 2 * kQ + 2 * kS +
                                (kBf16 ? 3 : 2) * kP + 2 * kOk + 2 * kRow +
                                kSegQ + kSegK;
};

struct Carve {
  unsigned char* p;
  template <typename U> __device__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

// C (M x N, fp32, shared memory, leading dim ldc) = A·B, or += when acc,
// for A (M x K) and B (K x N) in shared memory:
//   A(i, k) = A_COL ? a[k * lda + i] : a[i * lda + k]
//   B(k, j) = B_COL ? b[j * ldb + k] : b[k * ldb + j]
// Called by every thread of the block; no barrier inside.
// bf16: tensor cores through WMMA, one warp per 16x16 output tile.
template <int M, int N, int K, bool A_COL, bool B_COL>
__device__ __forceinline__ void mm(float* c, int ldc, const __nv_bfloat16* a,
                                   int lda, const __nv_bfloat16* b, int ldb,
                                   bool acc) {
  using LA = std::conditional_t<A_COL, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<B_COL, wmma::col_major, wmma::row_major>;
  constexpr int TN = N / 16;
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < (M / 16) * TN; t += kWarps) {
    const int i0 = (t / TN) * 16;
    const int j0 = (t % TN) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
    if (acc)
      wmma::load_matrix_sync(fc, c + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
      wmma::load_matrix_sync(fa, A_COL ? a + k0 * lda + i0 : a + i0 * lda + k0,
                             lda);
      wmma::load_matrix_sync(fb, B_COL ? b + j0 * ldb + k0 : b + k0 * ldb + j0,
                             ldb);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(c + i0 * ldc + j0, fc, ldc, wmma::mem_row_major);
  }
}

// fp32: plain FMAs, one thread per 4x4 output tile.
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
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int row0, int n_rows, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
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

// ---------------------------------------------------------------------------
// Forward: grid (query tiles, BH); out (BH, sq, D), lse (BH, sq)
// ---------------------------------------------------------------------------
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, int sq,
    int sk, int kv_rep, int causal, int causal_offset, int kv_limit,
    int seg_div, float scale) {
  using C = Cfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* qs = cv.take<T>(C::kQ);
  T* ks = cv.take<T>(C::kK);
  T* vs = cv.take<T>(C::kK);
  float* ss = cv.take<float>(C::kS);
  T* ps = cv.take<T>(C::kP);
  float* os = cv.take<float>(C::kOq);
  float* m_s = cv.take<float>(C::kRow);
  float* l_s = cv.take<float>(C::kRow);
  int* sq_s = cv.take<int>(C::kSegQ);
  int* sk_s = cv.take<int>(C::kSegK);

  // the longest causal rows first: the last query tile walks the most keys
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const T* kg = k + (int64_t)(bh / kv_rep) * sk * D;
  const T* vg = v + (int64_t)(bh / kv_rep) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_rows<T, D>(qs, C::LDT, q + (int64_t)bh * sq * D, q0, sq, BQ);
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
    load_rows<T, D>(ks, C::LDT, kg, k0, sk, BK);
    load_rows<T, D>(vs, C::LDT, vg, k0, sk, BK);
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
        ps[r * C::LDP + c] = from_float<T>(p);
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
    T* o = out + ((int64_t)bh * sq + row) * D;
    for (int c = lane; c < D; c += 32)
      o[c] = from_float<T>(os[r * C::LDO + c] / safe_l);
    if (lane == 0) lse[(int64_t)bh * sq + row] = m_s[r] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (query tiles, BH); dq (BH, sq, D)
// ---------------------------------------------------------------------------
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, int sq,
    int sk, int kv_rep, int causal, int causal_offset, int kv_limit,
    int seg_div, float scale) {
  using C = Cfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* qs = cv.take<T>(C::kQ);
  T* dos = cv.take<T>(C::kQ);
  T* ks = cv.take<T>(C::kK);
  T* vs = cv.take<T>(C::kK);
  float* ss = cv.take<float>(C::kS);
  float* dps = cv.take<float>(C::kS);
  T* dss = cv.take<T>(C::kP);
  float* acc = cv.take<float>(C::kOq);
  float* lse_s = cv.take<float>(C::kRow);
  float* delta_s = cv.take<float>(C::kRow);
  int* sq_s = cv.take<int>(C::kSegQ);
  int* sk_s = cv.take<int>(C::kSegK);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const T* kg = k + (int64_t)(bh / kv_rep) * sk * D;
  const T* vg = v + (int64_t)(bh / kv_rep) * sk * D;

  load_rows<T, D>(qs, C::LDT, q + (int64_t)bh * sq * D, q0, sq, BQ);
  load_rows<T, D>(dos, C::LDT, dout + (int64_t)bh * sq * D, q0, sq, BQ);
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
    load_rows<T, D>(ks, C::LDT, kg, k0, sk, BK);
    load_rows<T, D>(vs, C::LDT, vg, k0, sk, BK);
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
      dss[r * C::LDP + c] =
          from_float<T>(p * (dps[r * C::LDS + c] - delta_s[r]));
    }
    __syncthreads();
    mm<BQ, D, BK, false, false>(acc, C::LDO, dss, C::LDP, ks, C::LDT, true);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < sq)
      dq[((int64_t)bh * sq + q0 + r) * D + c] =
          from_float<T>(acc[r * C::LDO + c] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key tiles, BH / kv_rep); dk, dv (BH / kv_rep, sk, D)
// ---------------------------------------------------------------------------
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, int sq,
    int sk, int kv_rep, int causal, int causal_offset, int kv_limit,
    int seg_div, float scale) {
  using C = Cfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* ks = cv.take<T>(C::kK);
  T* vs = cv.take<T>(C::kK);
  T* qs = cv.take<T>(C::kQ);
  T* dos = cv.take<T>(C::kQ);
  float* ss = cv.take<float>(C::kS);
  float* dps = cv.take<float>(C::kS);
  T* ps = cv.take<T>(C::kP);
  T* dss = cv.take<T>(C::kP);
  float* dk_acc = cv.take<float>(C::kOk);
  float* dv_acc = cv.take<float>(C::kOk);
  float* lse_s = cv.take<float>(C::kRow);
  float* delta_s = cv.take<float>(C::kRow);
  int* sq_s = cv.take<int>(C::kSegQ);
  int* sk_s = cv.take<int>(C::kSegK);
  T* pls = C::kBf16 ? cv.take<T>(C::kP) : nullptr;  // bf16(P - bf16(P))

  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  load_rows<T, D>(ks, C::LDT, k + (int64_t)kvh * sk * D, k0, sk, BK);
  load_rows<T, D>(vs, C::LDT, v + (int64_t)kvh * sk * D, k0, sk, BK);
  zero(dk_acc, BK * C::LDO);
  zero(dv_acc, BK * C::LDO);
  const int n_qt = (sq + BQ - 1) / BQ;

  for (int rep = 0; k0 < kv_limit && rep < kv_rep; ++rep) {
    const int bh = kvh * kv_rep + rep;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (causal && q0 + BQ + causal_offset <= k0) continue;
      __syncthreads();  // the previous tile's products are done
      load_rows<T, D>(qs, C::LDT, q + (int64_t)bh * sq * D, q0, sq, BQ);
      load_rows<T, D>(dos, C::LDT, dout + (int64_t)bh * sq * D, q0, sq, BQ);
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
        const T p_hi = from_float<T>(p);
        ps[r * C::LDP + c] = p_hi;
        if constexpr (C::kBf16)
          pls[r * C::LDP + c] = from_float<T>(p - to_float<T>(p_hi));
        dss[r * C::LDP + c] =
            from_float<T>(p * (dps[r * C::LDS + c] - delta_s[r]));
      }
      __syncthreads();
      mm<BK, D, BQ, true, false>(dv_acc, C::LDO, ps, C::LDP, dos, C::LDT, true);
      if constexpr (C::kBf16) {
        // each warp owns the same dV tiles in both passes; its first
        // pass's stores must be visible to its lanes before the reload
        __syncwarp();
        mm<BK, D, BQ, true, false>(dv_acc, C::LDO, pls, C::LDP, dos, C::LDT,
                                   true);
      }
      mm<BK, D, BQ, true, false>(dk_acc, C::LDO, dss, C::LDP, qs, C::LDT, true);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r < sk) {
      const int64_t o = ((int64_t)kvh * sk + k0 + r) * D + c;
      dk[o] = from_float<T>(dk_acc[r * C::LDO + c] * scale);
      dv[o] = from_float<T>(dv_acc[r * C::LDO + c]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

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
  int bh, sq, sk, kv_rep, causal, causal_offset, kv_limit, seg_div;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool SEG>
cudaError_t launch_fwd(const Args& a) {
  using C = Cfg<T, D>;
  auto kernel = flash_attention_fwd_kernel<T, D, SEG>;
  cudaError_t e = set_smem(kernel, C::kFwd);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + C::BQ - 1) / C::BQ, a.bh);
  kernel<<<grid, kThreads, C::kFwd, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o0), a.lse_out, a.seg_q,
      a.seg_k, a.sq, a.sk, a.kv_rep, a.causal, a.causal_offset, a.kv_limit,
      a.seg_div, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t launch_dq(const Args& a) {
  using C = Cfg<T, D>;
  auto kernel = flash_attention_bwd_dq_kernel<T, D, SEG>;
  cudaError_t e = set_smem(kernel, C::kDq);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + C::BQ - 1) / C::BQ, a.bh);
  kernel<<<grid, kThreads, C::kDq, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.o0), a.seg_q, a.seg_k, a.sq, a.sk, a.kv_rep,
      a.causal, a.causal_offset, a.kv_limit, a.seg_div, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t launch_dkv(const Args& a) {
  using C = Cfg<T, D>;
  auto kernel = flash_attention_bwd_dkv_kernel<T, D, SEG>;
  cudaError_t e = set_smem(kernel, C::kDkv);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sk + C::BK - 1) / C::BK, a.bh / a.kv_rep);
  kernel<<<grid, kThreads, C::kDkv, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.seg_q, a.seg_k,
      a.sq, a.sk, a.kv_rep, a.causal, a.causal_offset, a.kv_limit, a.seg_div,
      a.scale);
  return cudaGetLastError();
}

enum class Which { kFwd, kDq, kDkv };

template <typename T, int D, bool SEG>
cudaError_t dispatch_seg(Which w, const Args& a) {
  switch (w) {
    case Which::kFwd: return launch_fwd<T, D, SEG>(a);
    case Which::kDq: return launch_dq<T, D, SEG>(a);
    default: return launch_dkv<T, D, SEG>(a);
  }
}

template <typename T, int D>
cudaError_t dispatch_kind(Which w, const Args& a) {
  return a.seg_q ? dispatch_seg<T, D, true>(w, a)
                 : dispatch_seg<T, D, false>(w, a);
}

// dtype: 0 = float32, 1 = bfloat16
int dispatch(Which w, int head_dim, int dtype, const Args& a) {
  // every output element is written only when there is a query and a key
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || a.kv_rep <= 0 ||
      a.bh % a.kv_rep != 0 || a.seg_div <= 0 ||
      (a.seg_q == nullptr) != (a.seg_k == nullptr))
    return (int)cudaErrorInvalidValue;
  if (head_dim == 64) {
    if (dtype == 0) return (int)dispatch_kind<float, 64>(w, a);
    if (dtype == 1) return (int)dispatch_kind<__nv_bfloat16, 64>(w, a);
  } else if (head_dim == 128) {
    if (dtype == 0) return (int)dispatch_kind<float, 128>(w, a);
    if (dtype == 1) return (int)dispatch_kind<__nv_bfloat16, 128>(w, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry returns a cudaError_t (0 on success); the Python wrapper raises
// on anything else. kv_limit is the number of keys that may be attended
// (kv_valid clamped to sk, or sk). seg_q/seg_k are both null (no segment
// ids) or both int32 (R, sq) / (R, sk) with seg_div = bh / R (bh when R = 1
// is one row shared by every bh).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* seg_q, const void* seg_k, int bh, int sq, int sk, int head_dim,
    int kv_rep, int dtype, int causal, int causal_offset, int kv_limit,
    int seg_div, float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr,
         static_cast<float*>(lse), static_cast<const int*>(seg_q),
         static_cast<const int*>(seg_k), bh, sq, sk, kv_rep, causal,
         causal_offset, kv_limit, seg_div, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(Which::kFwd, head_dim, dtype, a);
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* seg_q,
    const void* seg_k, int bh, int sq, int sk, int head_dim, int kv_rep,
    int dtype, int causal, int causal_offset, int kv_limit, int seg_div,
    float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr,
         static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), bh,
         sq, sk, kv_rep, causal, causal_offset, kv_limit, seg_div, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(Which::kDq, head_dim, dtype, a);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* seg_q,
    const void* seg_k, int bh, int sq, int sk, int head_dim, int kv_rep,
    int dtype, int causal, int causal_offset, int kv_limit, int seg_div,
    float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv, nullptr,
         static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), bh,
         sq, sk, kv_rep, causal, causal_offset, kv_limit, seg_div, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(Which::kDkv, head_dim, dtype, a);
}
