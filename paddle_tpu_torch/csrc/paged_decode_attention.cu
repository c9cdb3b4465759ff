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
// Design (decode has one query per row, so this is not a tensor-core
// kernel): one block per (row, kv head), or per (row, a slice of the GQA
// group) when the group is wider than the 4 query heads a block holds in
// registers. The block reads its own row of the block table (on the TPU it
// came in by scalar prefetch) and walks only the keys below seq_len, so each
// K and V row is read from device memory once for the whole GQA group. The
// walk is csrc/paged_decode.cuh's key split, which the ragged kernel's
// single-token tiles share: keys split across the block's 8 warps, 16-byte
// loads, online-softmax states merged across lanes and warps.
//
// What this design leaves on the table: a long row is walked by one block per
// kv head, so at small batch a few SMs stream the whole cache while the rest
// idle. Splitting the key axis across blocks with a second merge pass
// (flash-decoding) is the first speed item.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"

namespace {

using decode::kWarps;

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_attention_kernel(
    const T* __restrict__ q,                   // (B, nh, D)
    const T* __restrict__ k_pages,             // (P, page, nkv, D)
    const T* __restrict__ v_pages,             // (P, page, nkv, D)
    const int32_t* __restrict__ block_tables,  // (B, width)
    const int32_t* __restrict__ seq_lens,      // (B,)
    T* __restrict__ out,                       // (B, nh, D)
    int width, int page, int nh, int nkv, float scale) {
  __shared__ decode::States<D, REP> st;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * REP;  // first query head of this block
  const int g = h0 / (nh / nkv);    // their kv head
  // keys below seq_len, never past the table's span (a position over-decoded
  // past it has no page); uniform across the block
  const int n_keys = max(0, min(seq_lens[b], width * page));
  const int64_t off = ((int64_t)b * nh + h0) * D;
  decode::attend<T, D, REP>(q + off, k_pages, v_pages,
                            block_tables + (int64_t)b * width, n_keys, page,
                            nkv, g, scale, out + off, st);
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
