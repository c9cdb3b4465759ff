// The key-split decode of one query token over its paged keys, shared by
// paged_decode_attention.cu (the legacy pipeline's decode step: every row
// is one token) and ragged_paged_attention.cu (its single-token tiles: the
// unified step's decode tokens). Everything is in namespace decode.
//
// A block of kWarps warps computes, for REP query heads h0 .. h0 + REP - 1
// sharing kv head g,
//     out[h] = softmax(q[h] · K[0:n_keys]ᵀ · scale) · V[0:n_keys],
// reading key j from page block_table[j / page], slot j % page. Scores,
// the running max and sum, and the probabilities that weight V are fp32;
// the output is written in the pool dtype; n_keys 0 gives exactly 0.
//
// Design (decode has one query per head, so this is not a tensor-core
// loop; each K and V row is read once for the REP heads):
//   - 16-byte loads: a key row of D elements is read by D·sizeof(T)/16
//     lanes, so a warp reads 32·16 / (D·sizeof(T)) keys at once, and each
//     lane issues the loads of kUnroll such steps before their arithmetic;
//   - the key axis is split across the block's warps; the lanes that read
//     one key reduce its dot product with warp shuffles, and each lane
//     group keeps its own online-softmax state;
//   - the states are merged with shuffles inside each warp, then across
//     warps in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr float kNegInf = -1e30f;  // same fill as the Pallas kernels
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

// the warps' online-softmax states, merged in shared memory
template <int D, int REP> struct States {
  float m[kWarps][REP];
  float l[kWarps][REP];
  float acc[kWarps][REP][D];
};

// The REP heads of one token: q and out point at head h0's D values (the
// REP heads follow each other), bt at the token's row of the block table.
// Every thread of the block calls it with the same arguments; it leaves
// `st` free for the next call.
template <typename T, int D, int REP>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k_pages,
                                       const T* __restrict__ v_pages,
                                       const int32_t* __restrict__ bt,
                                       int n_keys, int page, int nkv, int g,
                                       float scale, T* __restrict__ out,
                                       States<D, REP>& st) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPK = D / VEC;         // lanes reading one key row
  constexpr int KPW = 32 / LPK;        // keys a warp reads per load step
  static_assert(LPK <= 32 && 32 % LPK == 0, "a key row must tile a warp");
  constexpr int STEP = kWarps * KPW * kUnroll;  // keys a block covers a step

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPK;  // which of the warp's KPW keys this lane reads
  const int dl = lane % LPK;   // which 16-byte chunk of the key row
  const unsigned full = 0xffffffffu;

  float qv[REP][VEC];
  float acc[REP][VEC];
  float m[REP];
  float l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    widen<T, VEC>(*reinterpret_cast<const uint4*>(q + r * D + dl * VEC),
                  qv[r]);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

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
          for (int i = 0; i < VEC; ++i)
            acc[r][i] = acc[r][i] * alpha + p * vv[i];
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
      for (int i = 0; i < VEC; ++i) st.acc[warp][r][dl * VEC + i] = acc[r][i];
      if (dl == 0) {
        st.m[warp][r] = m[r];
        st.l[warp][r] = l[r];
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
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, st.m[w][r]);
    float sum_l = 0.f;
    float sum_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(st.m[w][r] - mx);
      sum_l += st.l[w][r] * a;
      sum_a += st.acc[w][r][c] * a;
    }
    // l == 0 (no key): the accumulator is 0, so the output is exactly 0
    const float safe_l = sum_l == 0.f ? 1.f : sum_l;
    out[r * D + c] = from_float<T>(sum_a / safe_l);
  }
  __syncthreads();  // the states are free for the block's next token
}

}  // namespace decode
