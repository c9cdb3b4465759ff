// Ragged paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/paged_attention.py::_ragged_attention_kernel
//   (launched by ragged_paged_attention_pallas).
//
// What it computes (same contract as the Pallas kernel): a flat axis of T
// packed tokens, each owned by a row (token_row, -1 = pad slot) and sitting
// at an absolute position. Token t attends to its row's keys through the
// row's block table under the one mask rule
//     key_pos <= positions[t],
// pages at or past kv_lens[row] are skipped whole, GQA groups share their
// kv head, the softmax is online in fp32, the output is written in the pool
// dtype, and pad slots (and tokens with nothing to attend) come out exactly
// zero.
//
// What bounds it on an H100: device memory. Per query/key pair the kernel
// does 4·d operations on 4·d bytes of K and V (bf16), so its arithmetic
// intensity is about one operation per byte read, far below the ~295 at
// which the tensor cores would become the limit. The least time is the
// bytes of q, the output and the K/V the batch needs (each read once) over
// 3.35 TB/s.
//
// Design (simple first): one block per (token, kv head); one warp per query
// head of the GQA group. The block streams the token's keys 0..position
// page by page from the block table, staging each page's K and V slice for
// its kv head in shared memory once (16-byte vector loads) so every query
// head of the group reads it from there — each KV page is read from device
// memory once per group, as in the Pallas kernel. Each lane owns d/32
// dimensions of q and of the accumulator; a query/key score is a warp
// reduction, followed by the online-softmax update in registers.
//
// What this design leaves on the table: a prefill row's tokens each run in
// their own block, so a row's KV is re-read once per token (L2 absorbs most
// of it, device memory does not see all of it); there is no tensor-core
// (wgmma) path, no TMA, and no overlap of a page's load with the previous
// page's math. A redesign that tiles a row's tokens against its pages is a
// later PR's work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // same fill as the Pallas kernel

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

// DPL consecutive floats from shared memory in one vector load.
template <int DPL>
__device__ __forceinline__ void load_lane(const float* p, float (&r)[DPL]);
template <> __device__ __forceinline__ void load_lane<2>(const float* p,
                                                         float (&r)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  r[0] = v.x;
  r[1] = v.y;
}
template <> __device__ __forceinline__ void load_lane<4>(const float* p,
                                                         float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

template <typename T, int D>
__global__ void ragged_paged_attention_kernel(
    const T* __restrict__ q,                   // (T, nh, D)
    const T* __restrict__ k_pages,             // (P, page, nkv, D)
    const T* __restrict__ v_pages,             // (P, page, nkv, D)
    const int32_t* __restrict__ block_tables,  // (R, width)
    const int32_t* __restrict__ token_row,     // (T,)
    const int32_t* __restrict__ positions,     // (T,)
    const int32_t* __restrict__ kv_lens,       // (R,)
    T* __restrict__ out,                       // (T, nh, D)
    int n_rows, int width, int page, int nh, int nkv, float scale) {
  constexpr int DPL = D / 32;          // dimensions per lane
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float4 smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // (page, D)
  float* v_s = k_s + page * D;                      // (page, D)

  const int tok = blockIdx.x;
  const int g = blockIdx.y;  // kv head
  const int rep = nh / nkv;
  const int warp = threadIdx.x >> 5;  // query head within the group
  const int lane = threadIdx.x & 31;
  const int head = g * rep + warp;

  // keys this token attends: 0..min(position, span-1), where the span is
  // the row's kv_len rounded up to whole pages (the Pallas page skip) and
  // never wider than the block table. Uniform across the block, so the
  // __syncthreads() in the page loop is reached by every thread.
  const int row = token_row[tok];
  int n_keys = 0;
  if (row >= 0 && row < n_rows) {
    const int kv_len = kv_lens[row];
    if (kv_len > 0) {
      const int span = min((kv_len + page - 1) / page * page, width * page);
      n_keys = min(positions[tok] + 1, span);
    }
  }

  float qv[DPL];
  float acc[DPL];
  const int64_t o_off = ((int64_t)tok * nh + head) * D + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = n_keys > 0 ? to_float(q[o_off + i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int32_t* bt = block_tables + (int64_t)(row > 0 ? row : 0) * width;
  const int n_pages = (n_keys + page - 1) / page;
  const int chunks = page * (D / VEC);
  for (int p = 0; p < n_pages; ++p) {
    // element offset of (phys, slot 0, kv head g, dim 0)
    const int64_t base = ((int64_t)bt[p] * page * nkv + g) * D;
    for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
      const int t = i / (D / VEC);
      const int c = (i % (D / VEC)) * VEC;
      const int64_t off = base + (int64_t)t * nkv * D + c;
      const uint4 kr = *reinterpret_cast<const uint4*>(k_pages + off);
      const uint4 vr = *reinterpret_cast<const uint4*>(v_pages + off);
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        k_s[t * D + c + j] = to_float(ke[j]);
        v_s[t * D + c + j] = to_float(ve[j]);
      }
    }
    __syncthreads();
    const int kmax = min(page, n_keys - p * page);
    for (int t = 0; t < kmax; ++t) {
      float kk[DPL];
      load_lane<DPL>(k_s + t * D + lane * DPL, kk);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s += qv[i] * kk[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float pr = expf(s - m_new);
      l = l * alpha + pr;
      float vv[DPL];
      load_lane<DPL>(v_s + t * D + lane * DPL, vv);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = acc[i] * alpha + pr * vv[i];
      m = m_new;
    }
    __syncthreads();
  }

  // l == 0 (pad slot, idle row): acc is 0, so the output is exactly 0
  const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < DPL; ++i) out[o_off + i] = from_float<T>(acc[i] / safe_l);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* token_row,
                   const void* positions, const void* kv_lens, void* out,
                   int n_tokens, int n_rows, int width, int page, int nh,
                   int nkv, float scale, cudaStream_t stream) {
  const dim3 grid(n_tokens, nkv);
  const dim3 block(32 * (nh / nkv));
  const size_t smem = 2 * (size_t)page * D * sizeof(float);
  auto kernel = ragged_paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(token_row),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(kv_lens), static_cast<T*>(out), n_rows,
      width, page, nh, nkv, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t
// (0 on success); the Python wrapper raises on anything else.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* token_row, const void* positions,
    const void* kv_lens, void* out, int n_tokens, int n_rows, int width,
    int page, int nh, int nkv, int head_dim, int dtype, float scale,
    void* stream) {
  if (n_tokens == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || nh / nkv > 32 || page <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(T, D)                                                     \
  return (int)launch<T, D>(q, k_pages, v_pages, block_tables, token_row,    \
                           positions, kv_lens, out, n_tokens, n_rows, width, \
                           page, nh, nkv, scale, s)
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
