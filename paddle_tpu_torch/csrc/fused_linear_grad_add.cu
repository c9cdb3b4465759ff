// Weight-gradient GEMM with in-place accumulation for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/fused_linear.py:
//   _grad_add_kernel (launched by _pallas_grad_add) -> fused_linear_grad_add
//
// What it computes (the Pallas kernel's contract, for any shape):
//   out[din, dout] = acc + x[rows, din]^T . g[rows, dout]
// x and g are row-major and of one dtype (fp32, bf16 or fp16); the product is
// summed in fp32. out has the accumulator's dtype: fp32 (main_grad, the
// multi-precision case), or x's dtype, in which case the product is rounded
// to that dtype first and then added, as the JAX package's XLA path does. A
// null acc means 0; acc may be out itself (in place: each element is read
// and then written by the same thread).
//
// What bounds it on an H100: operations. 2·rows·din·dout operations on
// (rows·(din + dout) + 2·din·dout) elements; at rows 4096 that is over a
// thousand operations per byte, far above the ~295 where bf16 tensor cores
// stop waiting on memory. The least time is the operations over 989 TFLOP/s
// (bf16/fp16 tensor cores) or 67 TFLOP/s (fp32, which must not use TF32).
//
// Routes, chosen by the wrapper from shapes and alignment before the launch
// (ops/fused_linear.py::grad_add_route), each counted on its own:
//   wgmma: bf16/fp16 when TMA can map x and g (din and dout multiples of 8,
//          16-byte aligned bases; rows > 0) -- every main-path shape;
//   wmma:  bf16/fp16 otherwise (e.g. din 13), and rows == 0;
//   fma:   fp32 (wgmma takes no fp32 input, and TF32 would change the sums).
//
// wgmma design (namespace gemm90). A block owns a 128 x 256 tile of out:
// two consumer warpgroups of 64 rows each hold their 64 x 256 sum in
// registers (128 fp32 a thread), one producer warp keeps a ring of kStages
// stages filled by TMA, each the next 64 rows of x (two boxes of 64
// columns) and of g (four boxes), 128-byte swizzled, with a full and an
// empty mbarrier per stage. x^T is never formed: the x tile lands as
// [k][m] with m contiguous, which is wgmma's MN-major A operand (the
// transpose bit), and the g tile is an MN-major B operand spanning its
// four boxes (leading byte offset = one box). Each stage is four
// m64n256k16 wgmmas a warpgroup; a stage is released once the next
// stage's products are issued (one group kept in flight). TMA's zero fill
// past rows, din and dout replaces bound checks in the loop. An fp32 acc is
// loaded into the sum's registers before the loop (the Pallas kernel's
// order: out = acc, then += each block of rows), so its loads overlap the
// ring's fill; a 16-bit acc is added after the product is rounded to its
// dtype, eight pairs loaded at a time. The epilogue writes out from the
// registers with 8-byte (fp32) or 4-byte (16-bit) stores, guarded at din
// and dout; acc may be out (each element is read and then written by the
// same thread). Consecutive blocks walk 8 din tiles down a column of dout
// tiles, so the blocks in flight share x and g in L2. Where the output
// tiles fill
// less than one wave of SMs the wrapper splits the rows over blockIdx.z:
// each split writes its partial sum into a workspace and a fold kernel adds
// them in a fixed order, then the accumulator, so two runs are bitwise
// equal (no atomics). Setmaxnreg gives the consumers 232 registers, the
// producer warpgroup 40.
//
// WMMA design (for what TMA cannot map, and rows == 0). One block of 8 warps
// per 128 x 128 tile of out, walking rows in steps of 32 (16 for fp32):
// the Pallas grid's sequential k axis becomes that loop, and nothing is
// carried between blocks. Each step stages the x and g tiles into shared
// memory as they lie in device memory (row-major, 16-byte loads, zero-filled
// past every edge; a matrix whose rows are not 16-byte aligned is read
// element by element), and the next step's tiles are loaded into registers
// while this step's are multiplied. The row-major x tile in shared memory is
// WMMA's matrix_a in col_major. bf16/fp16 multiply through WMMA 16x16x16
// with fp32 accumulator fragments (a warp holds a 32 x 64 sub-tile, 2 x 4
// fragments); fp32 runs on the CUDA cores, 8 x 8 outputs a thread in
// registers. The epilogue adds the accumulator once and stores with bounds
// guards.
//
// What the wgmma design leaves on the table: blocks are not persistent, so
// a tile's epilogue (fp32 acc read and out written, 256 KB a block) does
// not overlap the next tile's loads; one block an SM (192 KB of stages).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kTile = 128;           // out rows (din) and columns (dout) a block
constexpr int kStepTc = 32;          // rows of x and g a step, tensor cores
constexpr int kStepFma = 16;         // rows a step, fp32 FMA
constexpr int kLd = kTile + 8;       // shared row: 16 bytes of padding for the
                                     // banks; WMMA's ld stays a multiple of 8

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return __half2float(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16(v);
  } else {
    return __float2half(v);
  }
}

// 16 bytes of row `row`, columns [col, col + 16 / sizeof(T)), of a row-major
// [rows, cols] matrix; 0 past every edge. `vec`: rows are 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ src,
                                            int row, int col, int rows,
                                            int cols, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return out;
  const T* p = src + static_cast<int64_t>(row) * cols + col;
  if (vec && col + kVec <= cols) return *reinterpret_cast<const uint4*>(p);
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if (col + e < cols) o[e] = p[e];
  }
  return out;
}

// The product (fp32) plus the accumulator, in the accumulator's dtype.
template <typename OutT>
__device__ __forceinline__ void finish(float prod, const OutT* acc,
                                       OutT* out, int64_t idx) {
  float v = prod;
  if constexpr (!std::is_same<OutT, float>::value) {
    v = to_f(from_f<OutT>(v));     // rounded to the accumulator's dtype first
  }
  if (acc != nullptr) v += to_f(acc[idx]);
  out[idx] = from_f<OutT>(v);
}

// Stages rows [k0, k0 + STEP) of x (columns i0..) and g (columns j0..):
// global -> registers with load(), registers -> shared with store().
template <typename T, int STEP, int LD>
struct Stager {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPerRow = kTile / kVec;
  static constexpr int kPer = STEP * kPerRow / kThreads;
  static_assert(STEP * kPerRow % kThreads == 0, "tile does not split evenly");
  uint4 rx[kPer], rg[kPer];

  __device__ __forceinline__ void load(const T* x, const T* g, int k0, int i0,
                                       int j0, int rows, int din, int dout,
                                       bool vec_x, bool vec_g) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int ch = threadIdx.x + u * kThreads;
      const int r = ch / kPerRow, c = (ch % kPerRow) * kVec;
      rx[u] = load_chunk(x, k0 + r, i0 + c, rows, din, vec_x);
      rg[u] = load_chunk(g, k0 + r, j0 + c, rows, dout, vec_g);
    }
  }

  __device__ __forceinline__ void store(T* xs, T* gs) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int ch = threadIdx.x + u * kThreads;
      const int r = ch / kPerRow, c = (ch % kPerRow) * kVec;
      *reinterpret_cast<uint4*>(xs + r * LD + c) = rx[u];
      *reinterpret_cast<uint4*>(gs + r * LD + c) = rg[u];
    }
  }
};

// bf16/fp16 in, tensor cores. Warp w holds out rows (w / 2)·32 + [0, 32) and
// columns (w % 2)·64 + [0, 64) of the block's tile.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
    grad_add_wmma(const T* __restrict__ x, const T* __restrict__ g,
                  const OutT* acc, OutT* out, int rows, int din, int dout,
                  bool vec_x, bool vec_g) {
  __shared__ __align__(128) T xs[2][kStepTc * kLd];
  __shared__ __align__(128) T gs[2][kStepTc * kLd];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(c[a][b], 0.0f);
  }

  Stager<T, kStepTc, kLd> st;
  const int steps = (rows + kStepTc - 1) / kStepTc;
  if (steps > 0) {
    st.load(x, g, 0, i0, j0, rows, din, dout, vec_x, vec_g);
    st.store(xs[0], gs[0]);
  }
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {
      st.load(x, g, (t + 1) * kStepTc, i0, j0, rows, din, dout, vec_x,
              vec_g);
    }
#pragma unroll
    for (int kk = 0; kk < kStepTc; kk += 16) {
      // element (m, k) of x^T is xs[k][m]: col_major with ld kLd
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        wmma::load_matrix_sync(a[mi], xs[buf] + kk * kLd + wm + mi * 16,
                               kLd);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        wmma::load_matrix_sync(b[ni], gs[buf] + kk * kLd + wn + ni * 16,
                               kLd);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          wmma::mma_sync(c[mi][ni], a[mi], b[ni], c[mi][ni]);
        }
      }
    }
    // buf ^ 1 was last read in step t - 1, which ended in a barrier
    if (t + 1 < steps) st.store(xs[buf ^ 1], gs[buf ^ 1]);
    __syncthreads();
  }

  float* sw = stage[warp];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      wmma::store_matrix_sync(sw, c[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      const int bi = i0 + wm + mi * 16, bj = j0 + wn + ni * 16;
      for (int e = lane; e < 256; e += 32) {
        const int ii = bi + e / 16, jj = bj + e % 16;
        if (ii < din && jj < dout) {
          finish(sw[e], acc, out, static_cast<int64_t>(ii) * dout + jj);
        }
      }
      __syncwarp();
    }
  }
}

// fp32 in, CUDA cores (no TF32). Thread (ty, tx) of a 16 x 16 grid holds out
// rows ty·4 + {0..3} and 64 + ty·4 + {0..3}, columns the same in tx.
__global__ void __launch_bounds__(kThreads)
    grad_add_fma(const float* __restrict__ x, const float* __restrict__ g,
                 const float* acc, float* out, int rows, int din, int dout,
                 bool vec_x, bool vec_g) {
  __shared__ __align__(16) float xs[2][kStepFma * kTile];
  __shared__ __align__(16) float gs[2][kStepFma * kTile];

  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float c[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) c[a][b] = 0.0f;
  }

  Stager<float, kStepFma, kTile> st;
  const int steps = (rows + kStepFma - 1) / kStepFma;
  if (steps > 0) {
    st.load(x, g, 0, i0, j0, rows, din, dout, vec_x, vec_g);
    st.store(xs[0], gs[0]);
  }
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {
      st.load(x, g, (t + 1) * kStepFma, i0, j0, rows, din, dout, vec_x,
              vec_g);
    }
#pragma unroll
    for (int r = 0; r < kStepFma; ++r) {
      const float* xr = xs[buf] + r * kTile;
      const float* gr = gs[buf] + r * kTile;
      const float4 a0 = *reinterpret_cast<const float4*>(xr + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(gr + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(gr + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int v = 0; v < 8; ++v) c[u][v] = fmaf(a[u], b[v], c[u][v]);
      }
    }
    if (t + 1 < steps) st.store(xs[buf ^ 1], gs[buf ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int ii = i0 + (u < 4 ? ty * 4 + u : 64 + ty * 4 + u - 4);
    if (ii >= din) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int jj = j0 + (v < 4 ? tx * 4 + v : 64 + tx * 4 + v - 4);
      if (jj < dout) {
        finish(c[u][v], acc, out, static_cast<int64_t>(ii) * dout + jj);
      }
    }
  }
}

template <typename T>
int launch_tc(const void* x, const void* g, const void* acc, void* out,
              int rows, int din, int dout, int out_fp32, bool vec_x,
              bool vec_g, dim3 grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (out_fp32) {
    grad_add_wmma<T, float><<<grid, kThreads, 0, stream>>>(
        xt, gt, static_cast<const float*>(acc), static_cast<float*>(out),
        rows, din, dout, vec_x, vec_g);
  } else {
    grad_add_wmma<T, T><<<grid, kThreads, 0, stream>>>(
        xt, gt, static_cast<const T*>(acc), static_cast<T*>(out), rows, din,
        dout, vec_x, vec_g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16/fp16 on Hopper: a TMA-fed ring of row slices, wgmma from shared memory,
// the 128 x 256 sum in registers (the building blocks are csrc/sm90.cuh's)
// ---------------------------------------------------------------------------
namespace gemm90 {

using namespace sm90;

constexpr int kBM = 128;                   // out rows (din) of a block
constexpr int kBN = 256;                   // out columns (dout) of a block
constexpr int kBK = 64;                    // rows of x and g a stage
constexpr int kStages = 4;                 // stages in the ring
constexpr int kConsumers = kBM / 64;       // warpgroups of 64 out rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kProducerRegs = 40;          // 128·40 + 256·232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kFoldThreads = 256;
constexpr int kGroupM = 8;  // din tiles a group of consecutive blocks covers
constexpr int kEpiChunk = 8;  // 16-bit accumulator pairs loaded at once

struct Smem {
  Box<kBK> a[kStages][kBM / kBoxCols];  // x: rows k0.., columns i0.. ([k][m])
  Box<kBK> b[kStages][kBN / kBoxCols];  // g: rows k0.., columns j0.. ([k][n])
  uint64_t full[kStages], empty[kStages];
};

struct Params {
  CUtensorMap x, g;  // (rows, din), (rows, dout): boxes of 64 rows x 64 cols
  const void* acc;   // the accumulator (may be out), or null
  void* out;         // out, or the splits' fp32 workspace (split, din, dout)
  int din, dout;
  int m_tiles, n_tiles;  // din and dout tiles
  int n_kt;              // 64-row slices of x and g
  int kps;               // slices a split walks
};

// The product pair (fp32) plus the accumulator pair, in the accumulator's
// dtype: rounded to it first when that is 16-bit (the JAX package's XLA
// path), as finish() does for one element.
template <typename OutT>
__device__ __forceinline__ void finish2(float p0, float p1, const OutT* acc,
                                        OutT* out, int64_t idx) {
  if constexpr (std::is_same<OutT, float>::value) {
    float2 v = make_float2(p0, p1);
    if (acc != nullptr) {
      const float2 a = *reinterpret_cast<const float2*>(acc + idx);
      v.x += a.x;
      v.y += a.y;
    }
    *reinterpret_cast<float2*>(out + idx) = v;
  } else {
    float v0 = to_f(from_f<OutT>(p0)), v1 = to_f(from_f<OutT>(p1));
    if (acc != nullptr) {
      v0 += to_f(acc[idx]);
      v1 += to_f(acc[idx + 1]);
    }
    out[idx] = from_f<OutT>(v0);
    out[idx + 1] = from_f<OutT>(v1);
  }
}

// grid (tiles, 1, splits). Consecutive blocks walk kGroupM din tiles down
// a column of dout tiles before the next column, so the blocks in flight
// share their x and g slices in L2 (a row of 43 dout tiles at dout 11008
// would stream 88 MB of g a wave). PARTIAL: write the split's plain fp32
// sum into its slice of the workspace (the fold finishes it).
template <typename T, typename OutT, bool PARTIAL>
__global__ void __launch_bounds__(kThreads, 1)
    grad_add_wgmma(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int per_group = kGroupM * p.n_tiles;
  const int first_m = (int)blockIdx.x / per_group * kGroupM;
  const int group_m = min(p.m_tiles - first_m, kGroupM);
  const int in_group = (int)blockIdx.x % per_group;
  const int i0 = (first_m + in_group % group_m) * kBM;
  const int j0 = in_group / group_m * kBN;
  const int kt0 = blockIdx.z * p.kps, kt1 = min(p.n_kt, kt0 + p.kps);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      bar_wait(&sm.empty[stage], phase ^ 1);
      bar_expect_tx(&sm.full[stage], sizeof(sm.a[0]) + sizeof(sm.b[0]));
#pragma unroll
      for (int b = 0; b < kBM / kBoxCols; ++b)
        tma_2d(&sm.a[stage][b], &p.x, &sm.full[stage], i0 + b * kBoxCols,
               kt * kBK);
#pragma unroll
      for (int b = 0; b < kBN / kBoxCols; ++b)
        tma_2d(&sm.b[stage][b], &p.g, &sm.full[stage], j0 + b * kBoxCols,
               kt * kBK);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  regs_alloc<kConsumerRegs>();
  // thread t holds rows r and r + 8 of its warpgroup's 64, columns
  // 8·j + 2·(t % 4) + {0, 1} (sm90.cuh's accumulator layout)
  const int t = threadIdx.x & 127, lane = t & 31;
  const int row0 = i0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
  const int col0 = j0 + 2 * (lane & 3);
  // An fp32 accumulator is the products' starting value, as in the Pallas
  // kernel (out = acc, then out += x^T g a block of rows at a time): its
  // loads are independent and overlap the ring's first stages, and the
  // epilogue only stores. (acc may be out, so loads issued after a store
  // could not be hoisted above it.) A 16-bit one is added after the
  // product is rounded to its dtype.
  constexpr bool kAccFirst = !PARTIAL && std::is_same<OutT, float>::value;
  float d[128];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool load = kAccFirst && p.acc != nullptr && row < p.din;
    // one base a row, constant offsets: no address lives across the loop
    const float* a_row = static_cast<const float*>(p.acc) +
                         (load ? (int64_t)row * p.dout + col0 : 0);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float2 a = make_float2(0.f, 0.f);
      if (load && col0 + 8 * j < p.dout)
        a = *reinterpret_cast<const float2*>(a_row + 8 * j);
      d[4 * j + 2 * h] = a.x;
      d[4 * j + 2 * h + 1] = a.y;
    }
  }
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    bar_wait(&sm.full[stage], phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma_ss_n256_tt<T>(d, desc_mn(sm.a[stage][wg], kk),
                        desc_mn(sm.b[stage][0], kk), 1);
    wg_commit();
    // the previous stage's products are done: its shared memory is free
    wg_wait<1>();
    if (prev >= 0) bar_arrive(&sm.empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wg_wait0();
  pin(d);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.din) continue;
    const int64_t base = (int64_t)row * p.dout + col0;
    if constexpr (PARTIAL) {
      float* ws = static_cast<float*>(p.out) +
                  (int64_t)blockIdx.z * p.din * p.dout + base;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        if (col0 + 8 * j < p.dout)  // dout is a multiple of 8: col + 1 fits
          *reinterpret_cast<float2*>(ws + 8 * j) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    } else if constexpr (std::is_same<OutT, float>::value) {
      float* o = static_cast<float*>(p.out) + base;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        if (col0 + 8 * j < p.dout)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    } else {
      OutT* o = static_cast<OutT*>(p.out) + base;
      const OutT* a_row = static_cast<const OutT*>(p.acc) +
                          (p.acc != nullptr ? base : 0);
#pragma unroll
      for (int j0c = 0; j0c < kBN / 8; j0c += kEpiChunk) {
        // a chunk's accumulator pairs loaded first, then its stores
        uint32_t a[kEpiChunk];
#pragma unroll
        for (int j = j0c; j < j0c + kEpiChunk; ++j)
          a[j - j0c] = p.acc != nullptr && col0 + 8 * j < p.dout
                           ? *reinterpret_cast<const uint32_t*>(a_row + 8 * j)
                           : 0u;
#pragma unroll
        for (int j = j0c; j < j0c + kEpiChunk; ++j) {
          if (col0 + 8 * j >= p.dout) continue;
          const OutT* ap = reinterpret_cast<const OutT*>(&a[j - j0c]);
          const float v0 = to_f(from_f<OutT>(d[4 * j + 2 * h])) + to_f(ap[0]);
          const float v1 =
              to_f(from_f<OutT>(d[4 * j + 2 * h + 1])) + to_f(ap[1]);
          *reinterpret_cast<uint32_t*>(o + 8 * j) = pack2<OutT>(v0, v1);
        }
      }
    }
  }
}

// out = acc + sum of the splits' partial sums, folded in split order; four
// elements a thread (din·dout is a multiple of 8)
template <typename OutT>
__global__ void __launch_bounds__(kFoldThreads)
    grad_add_fold(const float* __restrict__ ws, int split, int64_t n,
                  const OutT* acc, OutT* out) {
  const int64_t i =
      ((int64_t)blockIdx.x * kFoldThreads + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < split; ++z) {
    const float4 w = *reinterpret_cast<const float4*>(ws + z * n + i);
    s.x += w.x;
    s.y += w.y;
    s.z += w.z;
    s.w += w.w;
  }
  finish2<OutT>(s.x, s.y, acc, out, i);
  finish2<OutT>(s.z, s.w, acc, out, i + 2);
}

template <typename T, typename OutT>
cudaError_t launch(const void* x, const void* g, const void* acc, void* out,
                   void* ws, int rows, int din, int dout, int split,
                   cudaStream_t stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  if (!encode_map<T, 2>(&p.x, x, {(uint64_t)din, (uint64_t)rows},
                        {(uint64_t)din * 2}, {(uint32_t)kBoxCols, kBK}) ||
      !encode_map<T, 2>(&p.g, g, {(uint64_t)dout, (uint64_t)rows},
                        {(uint64_t)dout * 2}, {(uint32_t)kBoxCols, kBK}))
    return cudaErrorInvalidValue;
  p.din = din;
  p.dout = dout;
  p.n_kt = (rows + kBK - 1) / kBK;
  p.kps = (p.n_kt + split - 1) / split;
  // every split walks at least one slice (the wrapper sizes split so)
  if ((p.n_kt + p.kps - 1) / p.kps != split) return cudaErrorInvalidValue;
  p.m_tiles = (din + kBM - 1) / kBM;
  p.n_tiles = (dout + kBN - 1) / kBN;
  const dim3 grid(p.m_tiles * p.n_tiles, 1, split);
  constexpr size_t smem = sizeof(Smem) + 1024;  // + the 1024-byte alignment
  static_assert(smem <= 232448, "shared memory of one block");
  auto kernel = split > 1 ? grad_add_wgmma<T, OutT, true>
                          : grad_add_wgmma<T, OutT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  p.acc = acc;
  p.out = split > 1 ? ws : out;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const int64_t n = (int64_t)din * dout;
  const int64_t blocks = (n / 4 + kFoldThreads - 1) / kFoldThreads;
  grad_add_fold<OutT><<<(unsigned)blocks, kFoldThreads, 0, stream>>>(
      static_cast<const float*>(ws), split, n, static_cast<const OutT*>(acc),
      static_cast<OutT*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* x, const void* g, const void* acc,
                         void* out, void* ws, int rows, int din, int dout,
                         int out_fp32, int split, cudaStream_t stream) {
  return out_fp32 ? launch<T, float>(x, g, acc, out, ws, rows, din, dout,
                                     split, stream)
                  : launch<T, T>(x, g, acc, out, ws, rows, din, dout, split,
                                 stream);
}

}  // namespace gemm90

// dtype: 0 fp32, 1 bf16, 2 fp16 (x and g). out_fp32: out and acc are fp32,
// else of x's dtype. vec_x / vec_g: the rows of x / g are 16-byte aligned.
// Returns the launch's CUDA error code (0 on success).
extern "C" int fused_linear_grad_add_launch(const void* x, const void* g,
                                            const void* acc, void* out,
                                            int rows, int din, int dout,
                                            int dtype, int out_fp32,
                                            int vec_x, int vec_g,
                                            void* stream) {
  const dim3 grid((dout + kTile - 1) / kTile, (din + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      grad_add_fma<<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(acc), static_cast<float*>(out), rows,
          din, dout, vec_x != 0, vec_g != 0);
      return static_cast<int>(cudaGetLastError());
    case 1:
      return launch_tc<__nv_bfloat16>(x, g, acc, out, rows, din, dout,
                                      out_fp32, vec_x != 0, vec_g != 0, grid,
                                      s);
    case 2:
      return launch_tc<__half>(x, g, acc, out, rows, din, dout, out_fp32,
                               vec_x != 0, vec_g != 0, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wgmma route (bf16/fp16 only): x (rows, din) and g (rows, dout) with
// rows > 0, din and dout multiples of 8, x, g, acc and out 16-byte aligned.
// split > 1 sums the rows in that many parts into ws (split, din, dout)
// fp32 first (the wrapper allocates it and sizes split so that every part
// walks at least one 64-row slice). dtype and out_fp32 as above. Returns the
// launches' CUDA error code (0 on success).
extern "C" int fused_linear_grad_add_wgmma_launch(
    const void* x, const void* g, const void* acc, void* out, void* ws,
    int rows, int din, int dout, int dtype, int out_fp32, int split,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || din <= 0 || dout <= 0 || din % 8 || dout % 8 ||
      split < 1 || (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return static_cast<int>(gemm90::launch_dtype<__nv_bfloat16>(
        x, g, acc, out, ws, rows, din, dout, out_fp32, split, s));
  if (dtype == 2)
    return static_cast<int>(gemm90::launch_dtype<__half>(
        x, g, acc, out, ws, rows, din, dout, out_fp32, split, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a block of the wgmma route, for the smoke
// run's report.
extern "C" int fused_linear_grad_add_wgmma_smem_bytes() {
  return static_cast<int>(sizeof(gemm90::Smem) + 1024);
}
