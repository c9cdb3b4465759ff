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
// 3.35 TB/s. Reaching it takes loads in flight on every SM; a decode batch
// has few rows of very different lengths.
//
// Design: flash-decoding over csrc/paged_decode.cuh. The split kernel's grid
// is (key part, head group, row): a row of L keys is cut into ceil(L /
// chunk) parts of equal length, and a block takes one part of one row for
// REP query heads sharing a kv head (REP the largest of 4, 2, 1
// that divides the GQA group, so each K and V row is read once for REP
// heads), reads its row's block table itself (on the TPU it came in by
// scalar prefetch), and writes the part's fp32 softmax state to scratch;
// a block past the row's parts returns at once. The merge kernel folds each
// row's states in part order. So a 1000-key row is walked by 1000 / chunk
// blocks per head group at once, where one block walked it before. The
// chunk comes from host integers (ops/paged_attention.py::decode_split): as
// many parts as keep every row of the table's full span within one wave of
// resident blocks, since a part that waits for a second wave costs more than
// it saves (on an H100 the 7B legacy serve's rows of ~270 keys ran 26 %
// slower cut in two parts over 2.6 waves). At one chunk every row is written by its split
// block and the merge is not launched.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"

namespace {

using decode::kWarps;

// grid (n_chunks, nh / REP, batch). The second bound is the blocks per SM
// ptxas must fit: given the thread count alone it holds a one-head block
// (REP 1) at 64 registers, four blocks an SM, and spills; three blocks give
// it 80 registers, two give REP 2 and 4 their 96-128.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(kWarps * 32, REP == 1 ? 3 : 2)
    paged_decode_attention_kernel(
    const T* __restrict__ q,                   // (B, nh, D)
    const T* __restrict__ k_pages,             // (P, page, nkv, D)
    const T* __restrict__ v_pages,             // (P, page, nkv, D)
    const int32_t* __restrict__ block_tables,  // (B, width)
    const int32_t* __restrict__ seq_lens,      // (B,)
    T* __restrict__ out,                       // (B, nh, D)
    const decode::Partials part,               // (B, n_chunks, nh) states
    int32_t* __restrict__ n_split,             // (B,): chunks of each row
    int width, int page, int nh, int nkv, int chunk, float scale) {
  __shared__ decode::States<D, REP> st;
  const int c = blockIdx.x;
  const int h0 = blockIdx.y * REP;  // first query head of this block
  const int b = blockIdx.z;
  const int g = h0 / (nh / nkv);    // their kv head
  // keys below seq_len, never past the table's span (a position over-decoded
  // past it has no page); uniform across the block
  const int n_keys = max(0, min(__ldg(seq_lens + b), width * page));
  const int nc = decode::parts_of(n_keys, chunk);
  if (part.n_chunks > 1 && c == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    n_split[b] = nc;
  if (c >= nc) return;
  const int64_t off = ((int64_t)b * nh + h0) * D;
  decode::attend_part<T, D, REP>(q + off, k_pages, v_pages,
                                 block_tables + (int64_t)b * width, n_keys, c,
                                 nc, decode::ceil_div(n_keys, nc), page, nkv,
                                 g, h0, scale, out + off, part, b, st);
}

template <typename T, int D, int REP>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* seq_lens, void* out,
                   const decode::Partials& part, int32_t* n_split, int batch,
                   int width, int page, int nh, int nkv, int chunk,
                   float scale, cudaStream_t stream) {
  const dim3 grid(part.n_chunks, nh / REP, batch);
  paged_decode_attention_kernel<T, D, REP><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(seq_lens), static_cast<T*>(out), part,
      n_split, width, page, nh, nkv, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part.n_chunks == 1) return e;
  return decode::launch_merge<T, D>(part, n_split, out, batch, stream);
}

// REP query heads per block (decode::block_rep), so a block's heads always
// share one kv head.
template <typename T, int D>
cudaError_t launch_group(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* seq_lens, void* out,
                         const decode::Partials& part, int32_t* n_split,
                         int batch, int width, int page, int nh, int nkv,
                         int chunk, float scale, cudaStream_t stream) {
#define PTT_GROUP(REP)                                                       \
  return launch<T, D, REP>(q, k_pages, v_pages, block_tables, seq_lens, out, \
                           part, n_split, batch, width, page, nh, nkv,       \
                           chunk, scale, stream)
  const int rep = decode::block_rep(nh, nkv);
  if (rep == 4) PTT_GROUP(4);
  if (rep == 2) PTT_GROUP(2);
  PTT_GROUP(1);
#undef PTT_GROUP
}

}  // namespace

// Blocks of the split kernel one SM holds at once for this head layout,
// head dim and dtype; -1 for a shape the kernels do not take.
extern "C" int paged_decode_blocks_per_sm(int nh, int nkv, int head_dim,
                                          int dtype) {
  if (nkv <= 0 || nh % nkv != 0) return -1;
  const int r = decode::block_rep(nh, nkv);
  int n = -1;
#define PTT_OCC(T, D)                                                        \
  {                                                                          \
    cudaError_t e =                                                          \
        r == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
                     &n, paged_decode_attention_kernel<T, D, 4>, kWarps * 32, \
                     0)                                                      \
        : r == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(            \
                       &n, paged_decode_attention_kernel<T, D, 2>,           \
                       kWarps * 32, 0)                                       \
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(            \
                       &n, paged_decode_attention_kernel<T, D, 1>,           \
                       kWarps * 32, 0);                                      \
    return e == cudaSuccess ? n : -1;                                        \
  }
  if (head_dim == 64) {
    if (dtype == 0) PTT_OCC(float, 64);
    if (dtype == 1) PTT_OCC(__nv_bfloat16, 64);
    if (dtype == 2) PTT_OCC(__half, 64);
  } else if (head_dim == 128) {
    if (dtype == 0) PTT_OCC(float, 128);
    if (dtype == 1) PTT_OCC(__nv_bfloat16, 128);
    if (dtype == 2) PTT_OCC(__half, 128);
  }
#undef PTT_OCC
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. chunk: the most keys a
// split block takes; n_chunks = ceil(width·page / chunk). With n_chunks > 1, part is a
// float32 scratch of batch·n_chunks·nh·(head_dim + 2) and n_split an int32
// scratch of batch; with one chunk both may be null. Returns a cudaError_t
// (0 on success); the Python wrapper raises on anything else.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* out, void* part,
    void* n_split, int batch, int width, int page, int nh, int nkv,
    int head_dim, int dtype, int chunk, int n_chunks, float scale,
    void* stream) {
  if (batch == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || page <= 0 || width <= 0 || chunk <= 0 ||
      n_chunks != decode::ceil_div(width * page, chunk) || batch > 65535 ||
      (n_chunks > 1 && (part == nullptr || n_split == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* acc = static_cast<float*>(part);
  const decode::Partials parts{
      acc, acc == nullptr ? nullptr
                          : acc + (int64_t)batch * n_chunks * nh * head_dim,
      n_chunks, nh};
  int32_t* ns = static_cast<int32_t*>(n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(T, D)                                                  \
  return (int)launch_group<T, D>(q, k_pages, v_pages, block_tables,       \
                                 seq_lens, out, parts, ns, batch, width,  \
                                 page, nh, nkv, chunk, scale, s)
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
