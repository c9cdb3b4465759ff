// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/paged_attention.py::_paged_decode_kernel
//   (launched by paged_attention_pallas).
//
// What it computes (same contract as the Pallas kernel): one query token per
// row b, attending to the row's keys at positions < seq_lens[b] (and never
// past the block table's span, width·page), read page by page through
// block_tables[b]:
//     out[b, h] = softmax(q[b, h] · K_bᵀ · scale) · V_b,
// where query head h reads kv head h / (nh / nkv) (GQA). Scores, the running
// max and sum, and the probabilities that weight V are fp32; the output is
// written in the pool dtype. A row with no key (seq_len 0) comes out exactly
// zero, as the Pallas kernel's safe_l gives.
//
// What bounds it on an H100: device memory. Each key costs 4·d operations per
// query head on 4·d bytes of K and V (bf16), about one operation per byte,
// far below the ~295 at which the tensor cores would become the limit. The
// least time is the bytes of the K/V the batch's lengths need (each read once
// per kv head), q, the output, the block tables and the lengths, over
// 3.35 TB/s.
//
// Design (simple first; decode has one query per row, so this is not a
// tensor-core kernel):
//   - one block per (row, kv head), or per (row, a slice of the GQA group) when
//     the group is wider than the 4 query heads a block holds in registers;
//     the block loads its group's queries once;
//   - the block reads its own row of the block table (on the TPU it came in by
//     scalar prefetch) and walks only the keys below seq_len, so each K and V
//     row is read from device memory once for the whole GQA group;
//   - 16-byte loads: a key row of d elements is read by d·sizeof(T)/16 lanes,
//     so a warp reads 32·16 / (d·sizeof(T)) keys at once, and each lane issues
//     the loads of 4 such steps before it does their arithmetic;
//   - the key axis is split across the block's 8 warps; the lanes that read one
//     key reduce its dot product with warp shuffles, and each lane group keeps
//     its own online-softmax state;
//   - the states are merged with shuffles inside each warp, then across warps
//     in shared memory.
//
// What this design leaves on the table: a long row is walked by one block per
// kv head, so at small batch a few SMs stream the whole cache while the rest
// idle. Splitting the key axis across blocks with a second merge pass
// (flash-decoding) is the first speed item.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // same fill as the Pallas kernel
constexpr int kWarps = 8;          // warps per block, splitting the key axis
constexpr int kUnroll = 4;         // load steps a lane issues before computing

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// The VEC elements of T in one 16-byte word, widened to fp32.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const uint4& w, float (&r)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) r[i] = to_float(e[i]);
}

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_attention_kernel(
    const T* __restrict__ q,                   // (B, nh, D)
    const T* __restrict__ k_pages,             // (P, page, nkv, D)
    const T* __restrict__ v_pages,             // (P, page, nkv, D)
    const int32_t* __restrict__ block_tables,  // (B, width)
    const int32_t* __restrict__ seq_lens,      // (B,)
    T* __restrict__ out,                       // (B, nh, D)
    int width, int page, int nh, int nkv, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPK = D / VEC;         // lanes reading one key row
  constexpr int KPW = 32 / LPK;        // keys a warp reads per load step
  static_assert(LPK <= 32 && 32 % LPK == 0, "a key row must tile a warp");
  constexpr int STEP = kWarps * KPW * kUnroll;  // keys a block covers per step

  __shared__ float s_m[kWarps][REP];
  __shared__ float s_l[kWarps][REP];
  __shared__ float s_acc[kWarps][REP][D];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * REP;  // first query head of this block
  const int g = h0 / (nh / nkv);    // their kv head
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPK;  // which of the warp's KPW keys this lane reads
  const int dl = lane % LPK;   // which 16-byte chunk of the key row
  const unsigned full = 0xffffffffu;

  // keys below seq_len, never past the table's span (a position over-decoded
  // past it has no page); uniform across the block
  const int n_keys = max(0, min(seq_lens[b], width * page));

  float qv[REP][VEC];
  float acc[REP][VEC];
  float m[REP];
  float l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const int64_t q_off = ((int64_t)b * nh + h0 + r) * D + dl * VEC;
    widen<T, VEC>(*reinterpret_cast<const uint4*>(q + q_off), qv[r]);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  const int32_t* bt = block_tables + (int64_t)b * width;
  for (int base = warp * KPW * kUnroll; base < n_keys; base += STEP) {
    // issue every load of the step first: up to 2·kUnroll 16-byte loads in
    // flight per lane
    uint4 kw[kUnroll];
    uint4 vw[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * KPW + sub;
      ok[u] = j < n_keys;
      kw[u] = make_uint4(0u, 0u, 0u, 0u);
      vw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const int64_t phys = bt[j / page];
        const int64_t off =
            ((phys * page + j % page) * nkv + g) * D + dl * VEC;
        kw[u] = *reinterpret_cast<const uint4*>(k_pages + off);
        vw[u] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kk[VEC];
      float vv[VEC];
      widen<T, VEC>(kw[u], kk);
      widen<T, VEC>(vw[u], vv);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += qv[r][i] * kk[i];
        // the key's LPK lanes are aligned, so xor offsets below LPK stay
        // inside the group; every lane shuffles (the loop is warp-uniform)
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) s += __shfl_xor_sync(full, s, o);
        if (ok[u]) {
          s *= scale;
          const float m_new = fmaxf(m[r], s);
          const float alpha = expf(m[r] - m_new);
          const float p = expf(s - m_new);
          l[r] = l[r] * alpha + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] = acc[r][i] * alpha + p * vv[i];
          m[r] = m_new;
        }
      }
    }
  }

  // merge the warp's KPW lane groups (lanes dl, dl + LPK, ...): a butterfly,
  // so every lane ends with the warp's state for its chunk of dimensions.
  // An empty state (m -1e30, l 0) merges in with weight exp(-1e30 - m) = 0.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float m2 = __shfl_xor_sync(full, m[r], o);
      const float l2 = __shfl_xor_sync(full, l[r], o);
      const float mn = fmaxf(m[r], m2);
      const float a1 = expf(m[r] - mn);
      const float a2 = expf(m2 - mn);
      l[r] = l[r] * a1 + l2 * a2;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float x2 = __shfl_xor_sync(full, acc[r][i], o);
        acc[r][i] = acc[r][i] * a1 + x2 * a2;
      }
      m[r] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) s_acc[warp][r][dl * VEC + i] = acc[r][i];
      if (dl == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge across warps, one output element per thread
  for (int e = threadIdx.x; e < REP * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float sum_l = 0.f;
    float sum_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(s_m[w][r] - mx);
      sum_l += s_l[w][r] * a;
      sum_a += s_acc[w][r][c] * a;
    }
    // l == 0 (no key): the accumulator is 0, so the output is exactly 0
    const float safe_l = sum_l == 0.f ? 1.f : sum_l;
    out[((int64_t)b * nh + h0 + r) * D + c] = from_float<T>(sum_a / safe_l);
  }
}

template <typename T, int D, int REP>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* seq_lens, void* out,
                   int batch, int width, int page, int nh, int nkv,
                   float scale, cudaStream_t stream) {
  const dim3 grid(batch, nh / REP);
  paged_decode_attention_kernel<T, D, REP><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(seq_lens), static_cast<T*>(out), width,
      page, nh, nkv, scale);
  return cudaGetLastError();
}

// REP query heads per block: the largest of 4, 2, 1 that divides the GQA
// group, so a block's heads always share one kv head.
template <typename T, int D>
cudaError_t launch_group(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* seq_lens, void* out, int batch, int width,
                         int page, int nh, int nkv, float scale,
                         cudaStream_t stream) {
  const int rep = nh / nkv;
  if (rep % 4 == 0)
    return launch<T, D, 4>(q, k_pages, v_pages, block_tables, seq_lens, out,
                           batch, width, page, nh, nkv, scale, stream);
  if (rep % 2 == 0)
    return launch<T, D, 2>(q, k_pages, v_pages, block_tables, seq_lens, out,
                           batch, width, page, nh, nkv, scale, stream);
  return launch<T, D, 1>(q, k_pages, v_pages, block_tables, seq_lens, out,
                         batch, width, page, nh, nkv, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t
// (0 on success); the Python wrapper raises on anything else.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* out, int batch,
    int width, int page, int nh, int nkv, int head_dim, int dtype,
    float scale, void* stream) {
  if (batch == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || page <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(T, D)                                                  \
  return (int)launch_group<T, D>(q, k_pages, v_pages, block_tables,       \
                                 seq_lens, out, batch, width, page, nh,   \
                                 nkv, scale, s)
  if (head_dim == 64) {
    if (dtype == 0) PTT_LAUNCH(float, 64);
    if (dtype == 1) PTT_LAUNCH(__nv_bfloat16, 64);
    if (dtype == 2) PTT_LAUNCH(__half, 64);
  } else if (head_dim == 128) {
    if (dtype == 0) PTT_LAUNCH(float, 128);
    if (dtype == 1) PTT_LAUNCH(__nv_bfloat16, 128);
    if (dtype == 2) PTT_LAUNCH(__half, 128);
  }
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
