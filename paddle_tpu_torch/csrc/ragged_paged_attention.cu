// Ragged paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/paged_attention.py::_ragged_attention_kernel
//   (launched by ragged_paged_attention_pallas).
//
// What it computes (same contract as the Pallas kernel): a flat axis of T
// packed tokens, each owned by a row (token_row; -1, or a row past the
// tables, is a pad slot) and sitting at an absolute position. Token t
// attends to its row's keys through the row's block table under the one
// mask rule
//     key_pos <= positions[t],
// keys at or past kv_lens[row] rounded up to whole pages are skipped (the
// Pallas page skip), and never past the table's width·page; GQA groups
// share their kv head, the softmax is online in fp32, the output is written
// in the pool dtype, and pad slots (and tokens with nothing to attend) come
// out exactly zero.
//
// What bounds it on an H100: device memory for decode tokens, which do
// 4·d operations per key on 4·d bytes of K and V (bf16); a prefill tile of
// 64 query rows does 64 times the operations on the same bytes, still
// below the ~295 operations per byte where the tensor cores would become
// the limit. The least time is the bytes of q, the output and the K/V the
// batch needs (each read once) over 3.35 TB/s.
//
// Design. The flat axis is cut into tiles: a tile is a run of up to TS
// consecutive tokens of one row (TS = 64 / (nh / nkv), so that a tile's
// tokens times the GQA group's heads fill wgmma's 64 rows). On the engine's
// packing a row's prefill chunk is one run and a decode token a run of one;
// any layout stays correct, a scattered one only makes runs shorter. The
// tiles are found on the device, by a warp-wide scan of token_row and the
// per-token flags `decoding` inside each kernel (no host sync, no extra
// launch): a run starts where the row changes and at every decoding token,
// a tile at every TS-th token of a run.
//
// The route follows the token, not the packing: a decoding token (a decode
// step's token, or a speculative span's carry and drafts) is a run and a
// tile of its own on the key split, whatever its neighbours; every other
// token is tiled with its run on the wgmma kernel, a lone one too. A token
// then gets the same bits wherever the host packs it (the wgmma tile's
// other rows, and its walked key tiles past the token's position, add
// exact zeros), so a speculative span's tokens equal the same tokens
// decoded one at a time. Two kernels share the work of one call, each with
// a grid sized from T and the card alone whose blocks walk their items
// round-robin (a third merges split tokens):
//   - tiles of tokens that do not decode (ragged90, bf16/fp16 pools whose page
//     size divides 64 and is at least 8): the flash forward with a paged
//     producer. One consumer warpgroup runs S = Q·Kᵀ and P·V as wgmma
//     m64n64k16 (Q and K K-major, V MN-major), the online softmax in
//     registers, per element mask key <= position of the row's token; one
//     producer warp walks the row's keys in tiles of 64, issuing per page
//     a TMA box of (page keys x 64 columns) of the kv head into a ring of
//     two 128-byte swizzled stages (the maps are 3-D over the pool viewed
//     as (P·page, nkv, d)), and loads Q as one box of (TS tokens x the
//     group's heads x 64 columns). Keys past the tile's largest position
//     are never loaded; a page past the row's kv_len in the last tile is
//     read as TMA's zero fill past the pool. Each K/V page is read once per
//     GQA group.
//   - the decoding tokens (every token, for fp32 pools or other page sizes):
//     the flash-decoding split of csrc/paged_decode.cuh, shared with the
//     paged decode kernel. An item is a part of a token's keys; the
//     blocks walk the items round-robin (keys over 8 warps, 16-byte loads,
//     states merged across warps), so a long decode row is walked by many
//     blocks at once. A token of several parts leaves fp32 states in a
//     scratch sized from T and the span (the tokens that decode are found
//     on the device, never told to the host), and a merge kernel folds
//     them in chunk order. These blocks also write the pad slots' zeros.
// The wrapper picks TS (1: key split only) from dtype and shapes, and the
// chunk from host integers (ops/paged_attention.py::ragged_tile_size,
// decode_split), before the launch.
//
// What this design leaves on the table: one consumer warpgroup a block (a
// tile's softmax and its products do not overlap another tile's), and the
// kernels (tiles, key split, merge) run one after the other on the stream;
// every key-split block scans the whole token axis.

#include <algorithm>
#include <climits>
#include <cstring>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"
#include "sm90.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The loads of one step of a warp's scan of the flat token axis: token t =
// base + lane's row and its predecessor's, its position (0 without
// positions) and the decoding flags of it and its predecessor.
struct StepLoads {
  int r, rp, pos;
  bool d, dp;
};

__device__ __forceinline__ StepLoads load_step(
    const int32_t* __restrict__ token_row,
    const int32_t* __restrict__ positions,
    const uint8_t* __restrict__ decoding, int n_tokens, int base) {
  const int t = base + (threadIdx.x & 31);
  StepLoads s;
  s.r = t < n_tokens ? __ldg(token_row + t) : -1;
  s.rp = t > 0 && t <= n_tokens ? __ldg(token_row + t - 1) : INT_MIN;
  s.pos = positions != nullptr && t < n_tokens ? __ldg(positions + t) : 0;
  s.d = t < n_tokens && __ldg(decoding + t);
  s.dp = t > 0 && t <= n_tokens && __ldg(decoding + t - 1);
  return s;
}

// One step of the scan over the loads of step `base`. valid: the token
// belongs to a row (0 <= row < n_rows); tile_start: a tile starts at it
// (every ts-th token of its run). A decoding token is a run of its own.
// carry holds the latest run start before this step (-1 before any); every
// lane of the warp must call it with the same base.
__device__ __forceinline__ void scan_step(const StepLoads& s, int n_tokens,
                                          int n_rows, int ts, int base,
                                          int& carry, bool& valid,
                                          bool& tile_start) {
  const int lane = threadIdx.x & 31;
  const int t = base + lane;
  valid = t < n_tokens && s.r >= 0 && s.r < n_rows;
  const unsigned starts =
      __ballot_sync(kFull, valid && (s.rp != s.r || s.d || s.dp));
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
  const unsigned below = starts & upto;
  const int first = below ? base + 31 - __clz(below) : carry;
  if (starts) carry = base + 31 - __clz(starts);
  tile_start = valid && (t - first) % ts == 0;
}

// The items of a scan step that fall to this block: every gridDim.x-th
// item of the whole axis, counting from blockIdx.x. Each lane tests its own
// item, so a step costs a few instructions whatever its number of items;
// count is the items of the earlier steps and advances past this one's.
__device__ __forceinline__ unsigned take_mine(bool item, int& count) {
  const int lane = threadIdx.x & 31;
  const unsigned items = __ballot_sync(kFull, item);
  const int j = count + __popc(items & ((1u << lane) - 1u));
  count += __popc(items);
  return __ballot_sync(kFull, item && j % gridDim.x == blockIdx.x);
}

}  // namespace

// ---------------------------------------------------------------------------
// tiles of two or more tokens: wgmma from a TMA-fed paged ring
// ---------------------------------------------------------------------------
namespace ragged90 {

using namespace sm90;

constexpr int kRows = 64;                  // wgmma rows: tokens x group heads
constexpr int kKeys = 64;                  // keys of one walked tile
constexpr int kStages = 2;                 // walked tiles in flight
constexpr int kThreads = 128 + 32;         // a consumer warpgroup + producer
constexpr int kEndTile = -1;               // Info::pos: the tile is done
constexpr int kEndWork = -2;               // Info::pos: the block is done
enum : int { kSome = 1, kAll = 2 };        // a walked tile's pairs kept

// what the producer tells the consumer about a stage
struct Info {
  int pos;    // first key of the walked tile, or kEndTile / kEndWork
  int state;  // kSome: test each pair; kAll: every pair is kept
  int t0, n;  // the tile's first token and its number of tokens
  int limit;  // keys below it may be attended (kv_len's pages, the table)
};

template <int D> struct Smem {
  static constexpr int NB = D / kBoxCols;
  Box<kRows> q[NB];
  Box<kKeys> k[kStages][NB];
  Box<kKeys> v[kStages][NB];
  Info info[kStages];
  uint64_t full[kStages], empty[kStages], qfull, qempty;
};

struct Params {
  CUtensorMap q;     // (T, nh, D): boxes of (ts tokens, rep heads, 64 cols)
  CUtensorMap k, v;  // (P·page, nkv, D): boxes of (page keys, 1, 64 cols)
  const int32_t* block_tables;  // (R, width)
  const int32_t* token_row;     // (T,)
  const int32_t* positions;     // (T,)
  const int32_t* kv_lens;       // (R,)
  const uint8_t* decoding;      // (T,): tokens on the key split
  void* out;                    // (T, nh, D)
  int32_t* tile_map;            // null, or (T,): each token's tile start
  int n_tokens, n_rows, width, page, nh, nkv, rep, lrep, ts, pool_rows;
  float scale;
};

// keys of row r below this may be attended: kv_len rounded up to whole
// pages, never past the table
__device__ __forceinline__ int row_span(const Params& p, int r) {
  const int kv_len = __ldg(p.kv_lens + r);
  return kv_len > 0 ? min((kv_len + p.page - 1) / p.page * p.page,
                          p.width * p.page)
                    : 0;
}

// The producer warp: scans the tokens for the tiles of tokens that do not
// decode (a lone one too), takes every gridDim.x-th from blockIdx.x, loads
// its Q and walks its keys.
template <int D>
__device__ __forceinline__ void produce(const Params& p, Smem<D>& sm) {
  constexpr int NB = D / kBoxCols;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  const int ppt = kKeys / p.page;  // pages a walked tile
  int stage = 0, count = 0, carry = -1;
  uint32_t phase = 0, qphase = 0;
  for (int base = 0; base < p.n_tokens; base += 32) {
    bool valid, tile_start;
    const StepLoads cur =
        load_step(p.token_row, nullptr, p.decoding, p.n_tokens, base);
    scan_step(cur, p.n_tokens, p.n_rows, p.ts, base, carry, valid,
              tile_start);
    unsigned multi = take_mine(tile_start && !cur.d, count);
    while (multi) {
      const int b = __ffs(multi) - 1;
      multi &= multi - 1;
      const int t0 = base + b;
      const int r = __ldg(p.token_row + t0);
      // the tile's tokens: its run from t0, at most ts
      int n = 1;
      for (int off = 1; off < p.ts; off += 32) {
        const int i = off + lane;
        const bool same = i < p.ts && t0 + i < p.n_tokens &&
                          __ldg(p.token_row + t0 + i) == r &&
                          !__ldg(p.decoding + t0 + i);
        const unsigned m = __ballot_sync(kFull, same);
        if (m != kFull) {
          n += __ffs(~m) - 1;
          break;
        }
        n += 32;
      }
      int pmax = INT_MIN, pmin = INT_MAX;
      for (int i = lane; i < n; i += 32) {
        const int pos = __ldg(p.positions + t0 + i);
        pmax = max(pmax, pos);
        pmin = min(pmin, pos);
        if (p.tile_map != nullptr && g == 0) p.tile_map[t0 + i] = t0;
      }
      pmax = __reduce_max_sync(kFull, pmax);
      pmin = __reduce_min_sync(kFull, pmin);
      const int limit = max(0, min(pmax + 1, row_span(p, r)));
      // Q of the tile's tokens and the group's heads, once the consumer is
      // done with the last tile's
      bar_wait(&sm.qempty, qphase ^ 1);
      qphase ^= 1;
      if (lane == 0) bar_expect_tx(&sm.qfull, sizeof(sm.q));
      __syncwarp();
      if (lane < NB)
        tma_3d(&sm.q[lane], &p.q, &sm.qfull, lane * kBoxCols, g * p.rep, t0);
      const int32_t* bt = p.block_tables + (int64_t)r * p.width;
      const int n_pages = (limit + p.page - 1) / p.page;
      for (int k0 = 0; k0 < limit; k0 += kKeys) {
        bar_wait(&sm.empty[stage], phase ^ 1);
        if (lane == 0) {
          const int hi = k0 + kKeys - 1;
          sm.info[stage] = Info{k0, hi < limit && hi <= pmin ? kAll : kSome,
                                t0, n, limit};
          bar_expect_tx(&sm.full[stage], sizeof(sm.k[0]) + sizeof(sm.v[0]));
        }
        __syncwarp();
        // one copy a lane: (K or V, page of the tile, 64-column box); a page
        // past the row's keys reads TMA's zeros from past the pool
        for (int c = lane; c < 2 * ppt * NB; c += 32) {
          const int kv = c / (ppt * NB), pl = c % (ppt * NB) / NB,
                    bx = c % NB;
          const int pi = k0 / p.page + pl;
          const int key_row =
              pi < n_pages ? __ldg(bt + pi) * p.page : p.pool_rows;
          auto& box = kv ? sm.v[stage][bx] : sm.k[stage][bx];
          tma_3d(reinterpret_cast<unsigned char*>(&box) + pl * p.page * 128,
                 kv ? &p.v : &p.k, &sm.full[stage], bx * kBoxCols, g,
                 key_row);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      bar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) {
        sm.info[stage] = Info{kEndTile, 0, t0, n, limit};
        bar_arrive(&sm.full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  bar_wait(&sm.empty[stage], phase ^ 1);
  if (lane == 0) {
    sm.info[stage] = Info{kEndWork, 0, 0, 0, 0};
    bar_arrive(&sm.full[stage]);
  }
}

// The consumer warpgroup: thread t holds rows r = 16·(t / 32) + (t % 32) / 4
// and r + 8 of the 64 (token r >> lrep of the tile, head r & (rep - 1) of
// the group), each with its own running max, sum and output row.
template <typename T, int D>
__device__ __forceinline__ void consume(const Params& p, Smem<D>& sm) {
  constexpr int NB = D / kBoxCols, NS = kKeys / 2;
  const int t = threadIdx.x & 127, lane = t & 31;
  const int mrow0 = (t >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float sl2 = p.scale * kLog2e;  // scores in log2 units
  int stage = 0;
  uint32_t phase = 0, qphase = 0;
  for (;;) {
    bar_wait(&sm.full[stage], phase);
    Info in = sm.info[stage];
    if (in.pos == kEndWork) break;
    const int t0 = in.t0, n = in.n;
    int pos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = (mrow0 + 8 * h) >> p.lrep;
      pos[h] = i < n ? __ldg(p.positions + t0 + i) : -1;
    }
    bar_wait(&sm.qfull, qphase);
    qphase ^= 1;
    float o[NB][32];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
    float m[2] = {decode::kNegInf, decode::kNegInf}, l[2] = {0.f, 0.f};
    while (in.pos >= 0) {
      const int k0 = in.pos;
      float s[NS];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64<T>(s, desc_k(sm.q, kk), desc_k(sm.k[stage], kk), kk);
      wg_commit();
      wg_wait0();
      pin(s);
      // mask, scale, row max (a row lives in one quad of lanes)
      uint32_t kept = ~0u;
      float mx[2] = {decode::kNegInf, decode::kNegInf};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i >> 1) & 1;
        float x = s[i] * sl2;
        if (in.state == kSome) {
          const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
          if (key >= in.limit || key > pos[h]) {
            x = decode::kNegInf;
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
      // O += P·V, P rounded to the pool dtype, from the registers
      uint32_t pa[kKeys / 16][4];
      to_a<T>(s, pa);
#pragma unroll
      for (int b = 0; b < NB; ++b) pin(o[b]);
      wg_fence();
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          mma_rs_n64<T>(o[b], pa[kk], desc_mn(sm.v[stage][b], kk));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int b = 0; b < NB; ++b) pin(o[b]);
      pin(pa);
      bar_arrive(&sm.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      bar_wait(&sm.full[stage], phase);
      in = sm.info[stage];
    }
    // the end-of-tile stage; every product of the tile is done, so Q is
    // free for the producer's next tile
    bar_arrive(&sm.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    bar_arrive(&sm.qempty);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mrow = mrow0 + 8 * h, i = mrow >> p.lrep;
      if (i >= n) continue;
      // l == 0 (nothing attended): o is 0, so the output is exactly 0
      const float inv = l[h] == 0.f ? 1.f : 1.f / l[h];
      T* out = static_cast<T*>(p.out) +
               ((int64_t)(t0 + i) * p.nh + blockIdx.y * p.rep +
                (mrow & (p.rep - 1))) * D;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int e = 4 * c + 2 * h;
          *reinterpret_cast<uint32_t*>(out + b * kBoxCols + 8 * c + col0) =
              pack2<T>(o[b][e] * inv, o[b][e + 1] * inv);
        }
    }
  }
}

// grid (blocks walking the tiles round-robin, nkv)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    ragged_tiles_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<D>*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], 128);
    }
    bar_init(&sm.qfull, 1);
    bar_init(&sm.qempty, 128);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128) produce<D>(p, sm);
  else consume<T, D>(p, sm);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int32_t* block_tables, const int32_t* token_row,
                   const int32_t* positions, const int32_t* kv_lens,
                   const uint8_t* decoding, void* out, int32_t* tile_map,
                   int n_tokens, int n_rows, int width, int n_pages, int page,
                   int nh, int nkv, int ts, float scale,
                   cudaStream_t stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  const int rep = nh / nkv;
  const uint64_t pool_rows = (uint64_t)n_pages * page;
  if (!encode_map<T, 3>(&p.q, q, {(uint64_t)D, (uint64_t)nh,
                                  (uint64_t)n_tokens},
                        {(uint64_t)D * 2, (uint64_t)nh * D * 2},
                        {(uint32_t)kBoxCols, (uint32_t)rep, (uint32_t)ts}) ||
      !encode_map<T, 3>(&p.k, k_pages, {(uint64_t)D, (uint64_t)nkv,
                                        pool_rows},
                        {(uint64_t)D * 2, (uint64_t)nkv * D * 2},
                        {(uint32_t)kBoxCols, 1u, (uint32_t)page}) ||
      !encode_map<T, 3>(&p.v, v_pages, {(uint64_t)D, (uint64_t)nkv,
                                        pool_rows},
                        {(uint64_t)D * 2, (uint64_t)nkv * D * 2},
                        {(uint32_t)kBoxCols, 1u, (uint32_t)page}))
    return cudaErrorInvalidValue;
  p.block_tables = block_tables;
  p.token_row = token_row;
  p.positions = positions;
  p.kv_lens = kv_lens;
  p.decoding = decoding;
  p.out = out;
  p.tile_map = tile_map;
  p.n_tokens = n_tokens;
  p.n_rows = n_rows;
  p.width = width;
  p.page = page;
  p.nh = nh;
  p.nkv = nkv;
  p.rep = rep;
  p.lrep = __builtin_ctz((unsigned)rep);
  p.ts = ts;
  p.pool_rows = (int)pool_rows;
  p.scale = scale;
  constexpr size_t smem = sizeof(Smem<D>) + 1024;  // + the alignment
  auto kernel = ragged_tiles_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // as many blocks as are resident at once (one wave: the tiles a block
  // walks never wait behind another wave), but no more per kv head than
  // there can be tiles
  static const int resident = resident_blocks(kernel, kThreads, smem);
  const int per_head = max(1, resident / nkv);
  const dim3 grid(max(1, min(per_head, n_tokens)), nkv);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace ragged90

// ---------------------------------------------------------------------------
// single-token tiles (and pad slots): the key split of paged_decode.cuh
// ---------------------------------------------------------------------------
namespace {

// grid (nh / REP head groups, blocks walking the items round-robin); an
// item is a part of a single-token tile's keys, or a pad slot. The head
// groups vary fastest, so the blocks that take one item for every group
// land on as many SMs (with the item blocks fastest, a long decode row's
// 32 walks shared 11 SMs and ran 9 µs slower). Every warp scans the tokens
// itself, so the whole block agrees on its items without a barrier. The
// second bound is the blocks per SM ptxas must fit: given
// the thread count alone it holds a one-head block (REP 1) at 64 registers
// and spills; three blocks give it 80, two REP 2 its ~110, and REP 4 (~160
// with the scan) fits one.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(decode::kWarps * 32,
                                  REP == 1 ? 3 : REP == 2 ? 2 : 1)
    ragged_key_split_kernel(
    const T* __restrict__ q,                   // (T, nh, D)
    const T* __restrict__ k_pages,             // (P, page, nkv, D)
    const T* __restrict__ v_pages,             // (P, page, nkv, D)
    const int32_t* __restrict__ block_tables,  // (R, width)
    const int32_t* __restrict__ token_row,     // (T,)
    const int32_t* __restrict__ positions,     // (T,)
    const int32_t* __restrict__ kv_lens,       // (R,)
    const uint8_t* __restrict__ decoding,      // (T,)
    T* __restrict__ out,                       // (T, nh, D)
    int32_t* tile_map,                         // null, or (T,)
    const decode::Partials part,               // (T, n_chunks, nh) states
    int32_t* __restrict__ n_split,             // (T,): chunks of each token
    int n_tokens, int n_rows, int width, int page, int nh, int nkv, int ts,
    int chunk, float scale) {
  __shared__ decode::States<D, REP> st;
  const int h0 = blockIdx.x * REP;  // first query head of this block
  const int g = h0 / (nh / nkv);    // their kv head
  const int lane = threadIdx.x & 31;
  const int bx = blockIdx.y, blocks = gridDim.y;
  int count = 0, carry = -1;
  for (int base = 0; base < n_tokens; base += 32) {
    const StepLoads cur =
        load_step(token_row, positions, decoding, n_tokens, base);
    bool valid, tile_start;
    scan_step(cur, n_tokens, n_rows, ts, base, carry, valid, tile_start);
    const int t = base + lane;
    const bool pad = t < n_tokens && !valid;
    // the decoding tokens (the wgmma kernel takes every other token, a
    // lone one too), or every token where the call has no wgmma kernel
    const bool single = tile_start && (ts == 1 || cur.d);
    // this lane's items: a pad slot one, a single-token tile one per part
    // of its keys below its position + 1 and the table's span (a row's
    // kv_len, read only by the block that takes an item, may end them
    // sooner: those parts leave empty states), anything else none
    const int len = min(cur.pos + 1, width * page);
    const int nc = pad ? 1
                   : !single            ? 0
                   : part.n_chunks == 1 ? 1
                                        : decode::parts_of(len, chunk);
    // each token's marks are written by one block, picked round-robin
    if ((tile_map != nullptr || part.n_chunks > 1) && blockIdx.x == 0 &&
        t < n_tokens && t % blocks == bx) {
      if (tile_map != nullptr && nc > 0) tile_map[t] = pad ? -1 : t;
      if (part.n_chunks > 1) n_split[t] = single ? nc : 0;
    }
    // items are numbered along the axis; this block takes every blocks-th
    // from its own index (blockIdx.y). A lane's token holds items j0 ..
    // j0 + nc - 1, and `first` is the block's first among them.
    int j0, first;
    if (part.n_chunks == 1) {  // an item a token at most: two ballots
      const unsigned items = __ballot_sync(kFull, nc > 0);
      j0 = count + __popc(items & ((1u << lane) - 1u));
      count += __popc(items);
      first = j0 % blocks == bx ? j0 : j0 + 1;
    } else {  // a prefix sum of the items over the warp
      int incl = nc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      j0 = count + incl - nc;
      count += __shfl_sync(kFull, incl, 31);
      first = j0 + (bx - j0 % blocks + blocks) % blocks;
    }
    unsigned mine = __ballot_sync(kFull, first < j0 + nc);
    while (mine) {
      const int b = __ffs(mine) - 1;
      mine &= mine - 1;
      const int tb = base + b;
      const int jb = __shfl_sync(kFull, j0, b);
      const int ncb = __shfl_sync(kFull, nc, b);
      const int len_b = __shfl_sync(kFull, len, b);
      const int fb = __shfl_sync(kFull, first, b);
      const int64_t off = ((int64_t)tb * nh + h0) * D;
      if (__shfl_sync(kFull, (int)pad, b)) {  // a pad slot: exactly 0
        for (int e = threadIdx.x; e < REP * D; e += blockDim.x)
          out[off + e] = decode::from_float<T>(0.f);
        continue;
      }
      // the token's keys: below its position + 1, never past its row's
      // kv_len in whole pages or the table
      const int r = __shfl_sync(kFull, cur.r, b);
      const int kv_len = __ldg(kv_lens + r);
      const int span =
          kv_len > 0 ? min((kv_len + page - 1) / page * page, width * page)
                     : 0;
      const int n_keys = max(0, min(len_b, span));
      for (int j = fb; j < jb + ncb; j += blocks)
        decode::attend_part<T, D, REP>(
            q + off, k_pages, v_pages, block_tables + (int64_t)r * width,
            n_keys, j - jb, ncb, decode::ceil_div(len_b, ncb), page, nkv, g,
            h0, scale, out + off, part, tb, st);
    }
  }
}

template <typename T, int D, int REP>
cudaError_t launch_key_split(const void* q, const void* k_pages,
                             const void* v_pages, const int32_t* block_tables,
                             const int32_t* token_row,
                             const int32_t* positions, const int32_t* kv_lens,
                             const uint8_t* decoding, void* out,
                             int32_t* tile_map, const decode::Partials& part,
                             int32_t* n_split,
                             int n_tokens, int n_rows, int width, int page,
                             int nh, int nkv, int ts, int chunk, float scale,
                             cudaStream_t stream) {
  // as many blocks as are resident at once, at most one per item: a second
  // wave would hold back the long rows' blocks it holds
  const int groups = nh / REP;
  auto kernel = ragged_key_split_kernel<T, D, REP>;
  static const int resident =
      sm90::resident_blocks(kernel, decode::kWarps * 32, 0);
  const int per_group = max(1, resident / groups);
  const int64_t items = (int64_t)n_tokens * part.n_chunks;
  const dim3 grid(groups, (int)std::max<int64_t>(
                              1, std::min<int64_t>(per_group, items)));
  kernel<<<grid, decode::kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, token_row, positions,
      kv_lens, decoding, static_cast<T*>(out), tile_map, part, n_split,
      n_tokens,
      n_rows, width, page, nh, nkv, ts, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part.n_chunks == 1) return e;
  return decode::launch_merge<T, D>(part, n_split, out, n_tokens, stream);
}

template <typename T, int D>
cudaError_t launch_all(const void* q, const void* k_pages, const void* v_pages,
                       const int32_t* block_tables, const int32_t* token_row,
                       const int32_t* positions, const int32_t* kv_lens,
                       const uint8_t* decoding, void* out, int32_t* tile_map,
                       const decode::Partials& part, int32_t* n_split,
                       int n_tokens, int n_rows, int width, int n_pages,
                       int page, int nh, int nkv, int ts, int chunk,
                       float scale, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (ts > 1) {
      const cudaError_t e = ragged90::launch<T, D>(
          q, k_pages, v_pages, block_tables, token_row, positions, kv_lens,
          decoding, out, tile_map, n_tokens, n_rows, width, n_pages, page,
          nh, nkv, ts, scale, stream);
      if (e != cudaSuccess) return e;
    }
  }
  // REP query heads a block (decode::block_rep)
  const int rep = decode::block_rep(nh, nkv);
#define PTT_KEY_SPLIT(REP)                                                  \
  return launch_key_split<T, D, REP>(q, k_pages, v_pages, block_tables,     \
                                     token_row, positions, kv_lens,         \
                                     decoding, out, tile_map, part,         \
                                     n_split, n_tokens,                     \
                                     n_rows, width, page, nh, nkv, ts,      \
                                     chunk, scale, stream)
  if (rep == 4) PTT_KEY_SPLIT(4);
  if (rep == 2) PTT_KEY_SPLIT(2);
  PTT_KEY_SPLIT(1);
#undef PTT_KEY_SPLIT
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. ts: tokens a tile; 1 runs
// every token through the key split, > 1 (bf16/fp16, page a multiple of 8
// dividing 64, ts·(nh / nkv) = 64) sends the tiles of tokens that do not
// decode to the wgmma kernel. decoding: (T,) bytes, nonzero for a token
// that takes the key split alone, whatever its neighbours (with ts > 1
// every other token takes the wgmma tiles, a lone one too; all zero: every
// valid token on the tiles). tile_map: null, or (T,) int32 that receives
// each token's tile start (-1 for a pad slot). chunk: the most keys a
// key-split item takes;
// n_chunks = ceil(width·page / chunk). With n_chunks > 1, part is a float32
// scratch of T·n_chunks·nh·(head_dim + 2) and n_split an int32 scratch of
// T; with one chunk both may be null. Returns a cudaError_t (0 on success);
// the Python wrapper raises on anything else.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* token_row, const void* positions,
    const void* kv_lens, const void* decoding, void* out, void* tile_map,
    void* part,
    void* n_split, int n_tokens, int n_rows, int width, int n_pages,
    int page, int nh, int nkv, int head_dim, int dtype, int ts, int chunk,
    int n_chunks, float scale, void* stream) {
  if (n_tokens == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || page <= 0 || width <= 0 || n_rows <= 0 ||
      ts < 1 || chunk <= 0 || decoding == nullptr ||
      n_chunks != decode::ceil_div(width * page, chunk) ||
      (n_chunks > 1 && (part == nullptr || n_split == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (ts > 1 &&
      (dtype == 0 || page % 8 != 0 || 64 % page != 0 ||
       ts * (nh / nkv) != 64 || (long long)n_pages * page > INT_MAX))
    return (int)cudaErrorInvalidValue;
  float* acc = static_cast<float*>(part);
  const decode::Partials parts{
      acc, acc == nullptr ? nullptr
                          : acc + (int64_t)n_tokens * n_chunks * nh * head_dim,
      n_chunks, nh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(T, D)                                                      \
  return (int)launch_all<T, D>(                                               \
      q, k_pages, v_pages, static_cast<const int32_t*>(block_tables),         \
      static_cast<const int32_t*>(token_row),                                 \
      static_cast<const int32_t*>(positions),                                 \
      static_cast<const int32_t*>(kv_lens),                                   \
      static_cast<const uint8_t*>(decoding), out,                             \
      static_cast<int32_t*>(tile_map), parts, static_cast<int32_t*>(n_split), \
      n_tokens, n_rows, width, n_pages, page, nh, nkv, ts, chunk, scale, s)
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

// Blocks of the key-split kernel one SM holds at once for this head layout,
// head dim and dtype (the persistent grid's blocks per SM); -1 for a shape
// the kernels do not take.
extern "C" int ragged_key_split_blocks_per_sm(int nh, int nkv, int head_dim,
                                              int dtype) {
  if (nkv <= 0 || nh % nkv != 0) return -1;
  const int r = decode::block_rep(nh, nkv);
  int n = -1;
#define PTT_OCC(T, D)                                                        \
  {                                                                          \
    cudaError_t e =                                                          \
        r == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
                     &n, ragged_key_split_kernel<T, D, 4>,                   \
                     decode::kWarps * 32, 0)                                 \
        : r == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(            \
                       &n, ragged_key_split_kernel<T, D, 2>,                 \
                       decode::kWarps * 32, 0)                               \
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(            \
                       &n, ragged_key_split_kernel<T, D, 1>,                 \
                       decode::kWarps * 32, 0);                              \
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

// Dynamic shared memory of a block of the wgmma kernel at head dim d (64 or
// 128), for the smoke run's report; -1 otherwise.
extern "C" int ragged_paged_attention_smem_bytes(int head_dim) {
  if (head_dim == 64) return (int)(sizeof(ragged90::Smem<64>) + 1024);
  if (head_dim == 128) return (int)(sizeof(ragged90::Smem<128>) + 1024);
  return -1;
}
