// The key split of one-query paged decode (flash-decoding), shared by
// paged_decode_attention.cu (the legacy pipeline's decode step: every row
// is one token) and ragged_paged_attention.cu (its single-token tiles: the
// unified step's decode tokens). Everything is in namespace decode.
//
// For REP query heads h0 .. h0 + REP - 1 sharing kv head g, one token
// attends to its keys 0 .. n_keys - 1,
//     out[h] = softmax(q[h] · K[0:n_keys]ᵀ · scale) · V[0:n_keys],
// reading key j from page block_table[j / page], slot j % page. Scores,
// the running max and sum, and the probabilities that weight V are fp32;
// the output is written in the pool dtype; n_keys 0 gives exactly 0.
//
// What bounds it on an H100: device memory. A key costs 4·d operations per
// query head on 4·d bytes of K and V (bf16), about one operation per byte;
// the least time is the bytes of the K/V the lengths need over 3.35 TB/s.
// Reaching it takes tens of kilobytes of loads in flight on every SM, so
// the work has to be spread over the whole card however the batch's
// lengths fall: a batch of one long row and seven short ones must not
// leave one SM per head streaming the long row while the rest idle.
//
// Design, in two kernels:
//   - split (attend): a token of L keys is cut into ceil(L / chunk) parts
//     of equal length (so no block walks a whole chunk beside another's
//     short tail), and a block takes one part of one token for REP heads.
//     Its 8 warps split the part's keys; a
//     key row of D elements is read with 16-byte loads by D·sizeof(T)/16
//     lanes, each lane issuing the loads of kUnroll steps before their
//     arithmetic; each lane group keeps an online-softmax state, merged
//     with shuffles inside a warp and in shared memory across warps. The
//     block writes the part's state (m, l, acc[D]) in fp32 to a scratch
//     buffer, or, when the token's keys fit one chunk, its output;
//   - merge: one block per (token, head) folds the token's part states
//     online in order, part 0 first, so the output is the same bits from
//     run to run, and writes it in the pool dtype.
// The chunk size comes from host integers alone (the table's span, the
// batch, the heads and the SM count; ops/paged_attention.py::decode_split),
// never from the lengths, so the host never waits on the card. A token's
// part count is written to n_split for the merge; a part that holds none
// of its keys leaves the empty state (-1e30, 0, 0), which the merge weighs
// by exp(-1e30 - m) = 0. A token of one part writes out / l directly, the
// same bits as the merge of that one state: exp(-1e30 - m) is 0, exp(m - m)
// is 1, and 0 · 0 + x · 1 is x.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr float kNegInf = -1e30f;  // same fill as the Pallas kernels
constexpr int kWarps = 8;          // warps per block, splitting the key axis
constexpr int kUnroll = 4;         // load steps a lane issues before computing
constexpr int kMergeSlots = 16;    // merge blocks along the token axis

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

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Query heads a key-split block holds (REP): the largest of 4, 2, 1 that
// divides the GQA group nh / nkv, so that they share one kv head.
__host__ __device__ __forceinline__ int block_rep(int nh, int nkv) {
  const int group = nh / nkv;
  return group % 4 == 0 ? 4 : group % 2 == 0 ? 2 : 1;
}

// Parts a token of n_keys keys is cut into: at least one, so that a token
// with no key still has a block that writes its zeros, and no part over
// `chunk` keys. The parts are balanced: ceil(n_keys / parts) keys each.
__device__ __forceinline__ int parts_of(int n_keys, int chunk) {
  return max(1, ceil_div(n_keys, chunk));
}

// the warps' online-softmax states, merged in shared memory
template <int D, int REP> struct States {
  float m[kWarps][REP];
  float l[kWarps][REP];
  float acc[kWarps][REP][D];
};

// Where a split writes a part's states: the scratch of `slots` tokens ×
// `n_chunks` parts at most × nh heads, acc (D floats a head) first, then
// (m, l).
struct Partials {
  float* acc;  // (slots, n_chunks, nh, D)
  float* ml;   // (slots, n_chunks, nh, 2)
  int n_chunks, nh;

  __device__ __forceinline__ int64_t state(int slot, int c, int h) const {
    return ((int64_t)slot * n_chunks + c) * nh + h;
  }
};

// The REP heads of one token over its keys key0 .. key1 - 1: q points at
// head h0's D values (the REP heads follow each other), bt at the token's
// row of the block table. Writes the normalised output to `out` (head h0's
// D values) when part_acc is null, else the part's fp32 states (m, l, acc)
// to part_acc / part_ml (head h0's). Every thread of the block calls it
// with the same arguments; it leaves `st` free for the next call.
template <typename T, int D, int REP>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k_pages,
                                       const T* __restrict__ v_pages,
                                       const int32_t* __restrict__ bt,
                                       int key0, int key1, int page, int nkv,
                                       int g, float scale, T* __restrict__ out,
                                       float* __restrict__ part_acc,
                                       float* __restrict__ part_ml,
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

  for (int base = key0 + warp * KPW * kUnroll; base < key1; base += STEP) {
    // issue every load of the step first: up to 2·kUnroll 16-byte loads in
    // flight per lane
    uint4 kw[kUnroll];
    uint4 vw[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * KPW + sub;
      ok[u] = j < key1;
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
    if (part_acc != nullptr) {
      part_acc[e] = sum_a;
      if (c == 0) {
        part_ml[2 * r] = mx;
        part_ml[2 * r + 1] = sum_l;
      }
    } else {
      // l == 0 (no key): the accumulator is 0, so the output is exactly 0
      const float safe_l = sum_l == 0.f ? 1.f : sum_l;
      out[e] = from_float<T>(sum_a / safe_l);
    }
  }
  __syncthreads();  // the states are free for the block's next item
}

// Part c of one token's keys 0 .. n_keys - 1, of n_split parts of `span`
// keys (the last may be shorter): its output when the token has one part,
// else its states in slot `slot` of `part` (the empty state where the part
// starts at or past n_keys). q and out point at head h0 of the token.
template <typename T, int D, int REP>
__device__ __forceinline__ void attend_part(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ bt, int n_keys,
    int c, int n_split, int span, int page, int nkv, int g, int h0,
    float scale, T* __restrict__ out, const Partials& part, int slot,
    States<D, REP>& st) {
  // one inlined walk for both kinds of part, its destination by pointer
  const bool whole = n_split == 1;
  const int64_t s = whole ? 0 : part.state(slot, c, h0);
  const int key0 = whole ? 0 : c * span;
  attend<T, D, REP>(q, k_pages, v_pages, bt, key0,
                    whole ? n_keys : min(key0 + span, n_keys), page, nkv, g,
                    scale, out, whole ? nullptr : part.acc + s * D,
                    whole ? nullptr : part.ml + s * 2, st);
}

// The merge: grid (kMergeSlots or fewer, nh), D threads; block (x, h) takes
// the tokens x, x + gridDim.x, ... whose n_split is over 1 and folds head
// h's part states in order into out (slots, nh, D).
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_merge_kernel(const Partials part, const int32_t* __restrict__ n_split,
                        T* __restrict__ out, int slots) {
  const int h = blockIdx.y;
  const int e = threadIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  for (int base = blockIdx.x; base < slots; base += 32 * gridDim.x) {
    // every warp reads the same 32 candidate tokens and agrees on the work
    const int s_lane = base + lane * gridDim.x;
    const int nc_lane = s_lane < slots ? __ldg(n_split + s_lane) : 0;
    unsigned todo = __ballot_sync(full, nc_lane > 1);
    while (todo) {
      const int b = __ffs(todo) - 1;
      todo &= todo - 1;
      const int slot = base + b * gridDim.x;
      const int nc = __shfl_sync(full, nc_lane, b);
      const int64_t s0 = part.state(slot, 0, h);
      const int64_t step = part.nh;  // states of one head, part to part
      // one online pass in part order: no part's loads wait on another's
      float mx = kNegInf;
      float sum_l = 0.f;
      float sum_a = 0.f;
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        const int64_t s = s0 + c * step;
        const float m = part.ml[s * 2];
        const float m_new = fmaxf(mx, m);
        const float a_old = expf(mx - m_new);
        const float a = expf(m - m_new);
        sum_l = sum_l * a_old + part.ml[s * 2 + 1] * a;
        sum_a = sum_a * a_old + part.acc[s * D + e] * a;
        mx = m_new;
      }
      const float safe_l = sum_l == 0.f ? 1.f : sum_l;
      out[((int64_t)slot * part.nh + h) * D + e] =
          from_float<T>(sum_a / safe_l);
    }
  }
}

// Launch the merge over `slots` tokens on `stream`.
template <typename T, int D>
cudaError_t launch_merge(const Partials& part, const int32_t* n_split,
                         void* out, int slots, cudaStream_t stream) {
  const dim3 grid(min(slots, kMergeSlots), part.nh);
  decode_merge_kernel<T, D>
      <<<grid, D, 0, stream>>>(part, n_split, static_cast<T*>(out), slots);
  return cudaGetLastError();
}

}  // namespace decode
