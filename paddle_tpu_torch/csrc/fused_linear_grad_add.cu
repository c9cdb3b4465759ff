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
// Design (simple first). One block of 8 warps per 128 x 128 tile of out,
// walking rows in steps of 32 (16 for fp32): the Pallas grid's sequential
// k axis becomes that loop, and nothing is carried between blocks. Each step
// stages the x and g tiles into shared memory as they lie in device memory
// (row-major, 16-byte loads, zero-filled past every edge; a matrix whose rows
// are not 16-byte aligned is read element by element), and the next step's
// tiles are loaded into registers while this step's are multiplied. x^T comes
// free: the row-major x tile in shared memory is WMMA's matrix_a in
// col_major, so x is never transposed in device memory. bf16/fp16 multiply
// on the tensor cores through WMMA 16x16x16 with fp32 accumulator fragments
// (a warp holds a 32 x 64 sub-tile, 2 x 4 fragments); fp32 runs on the CUDA
// cores, 8 x 8 outputs a thread in registers. The epilogue adds the
// accumulator once and stores with bounds guards.
//
// What this design leaves on the table: no wgmma, no TMA ring, one
// register-prefetched stage only, fragments reloaded from shared memory for
// every product, and no split over rows for shapes with few output tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
