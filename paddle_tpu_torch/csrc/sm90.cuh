// Hopper (sm_90a) building blocks shared by the port's hand-written kernels:
// mbarriers, TMA copies and the tensor maps they read, warpgroup register
// budgets, wgmma ordering, shared-memory matrix descriptors and the wgmma
// products themselves. flash_attention.cu, fused_linear_grad_add.cu and
// ragged_paged_attention.cu include it; each builds into its own library
// (ops/_common.py hashes every header under csrc/ into each library's name,
// so an edit here rebuilds all of them). Everything is in namespace sm90.
//
// Layout conventions. A tile in shared memory is a run of boxes of 64
// 16-bit columns (128-byte rows) in TMA's 128-byte swizzle, which is the
// layout wgmma's descriptors read; a box starts on a 1024-byte boundary so
// the descriptors' base offset stays 0. wgmma's operands are "K-major" when
// the reduction index runs along a 128-byte row (Q and K in S = Q·Kᵀ) and
// "MN-major" when the row runs along M or N (V in P·V; both operands of
// the weight-gradient GEMM, whose reduction runs over the rows of x and g).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBoxCols = 64;   // 16-bit columns of one 128-byte swizzled box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a wait on a barrier that outlasts this is a fault: trap instead of hang
constexpr unsigned long long kWatchdogNs = 4000000000ull;

// ROWS rows of 64 16-bit columns, 128 bytes each, as TMA's 128-byte swizzle
// writes them; a 1024-byte aligned base keeps wgmma's base offset at 0
template <int ROWS> struct alignas(1024) Box {
  uint16_t v[ROWS * kBoxCols];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  unsigned long long start = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 4095u) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > kWatchdogNs) __trap();
    }
  }
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// --- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// --- warpgroup register budgets and wgmma ordering ---------------------------

template <int N> __device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait0() { wg_wait<0>(); }

// Ties registers to this point of the program: an asynchronous wgmma reads
// its A registers and writes its accumulators until the wait, which the
// compiler cannot see, so both are pinned after the wait (and the
// accumulators before the issue).
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// --- shared-memory matrix descriptors ----------------------------------------

// wgmma descriptor of a 128-byte swizzled tile at p: 8-row groups 1024
// bytes apart (the stride byte offset) and `lbo` bytes between 64-column
// boxes along M or N (the leading byte offset, read only by an MN-major
// operand wider than one box; a K-major swizzled operand never reads it)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo = 1024) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}
// a K-major operand's k-th 16-column step of a D-column tile stored as
// boxes[D / 64]: box k / 4, 32 bytes a step inside it
template <typename B>
__device__ __forceinline__ uint64_t desc_k(const B* boxes, int kk) {
  return desc(&boxes[kk >> 2]) + 2 * (kk & 3);
}
// an MN-major operand's k-th 16-row step inside one box: 16 rows of 128 B
// (the boxes of a wider operand follow each other, sizeof(B) apart)
template <typename B>
__device__ __forceinline__ uint64_t desc_mn(const B& box, int kk) {
  return desc(&box, sizeof(B)) + 128 * kk;
}

// --- register fragments ------------------------------------------------------

// two floats as a packed pair of T (bf16 or fp16), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2<bf16>(lo, hi);
}

// The accumulator of a 64 x N wgmma: thread t of the warpgroup holds rows
// r = 16·(t / 32) + (t % 32) / 4 and r + 8, element i at row r + 8·((i >> 1)
// & 1), column 8·(i >> 2) + 2·(t % 4) + (i & 1). The A operand of a
// following wgmma takes the same layout, 16 columns (8 elements) a step.
template <typename T = bf16, int N>
__device__ __forceinline__ void to_a(const float (&c)[N],
                                     uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack2<T>(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the SFU, denormal results flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- wgmma (bf16 or fp16 in, fp32 accumulate) --------------------------------

#define SM90_ACC8(d, i)                                                   \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_ACC32(d, i)                                                  \
  SM90_ACC8(d, i + 0), SM90_ACC8(d, i + 8), SM90_ACC8(d, i + 16),         \
      SM90_ACC8(d, i + 24)
#define SM90_REGS32                                                       \
  "{"                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31"                                \
  "}"
#define SM90_REGS128                                                      \
  "{"                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
  "%56, %57, %58, %59, %60, %61, %62, %63, "                              \
  "%64, %65, %66, %67, %68, %69, %70, %71, "                              \
  "%72, %73, %74, %75, %76, %77, %78, %79, "                              \
  "%80, %81, %82, %83, %84, %85, %86, %87, "                              \
  "%88, %89, %90, %91, %92, %93, %94, %95, "                              \
  "%96, %97, %98, %99, %100, %101, %102, %103, "                          \
  "%104, %105, %106, %107, %108, %109, %110, %111, "                      \
  "%112, %113, %114, %115, %116, %117, %118, %119, "                      \
  "%120, %121, %122, %123, %124, %125, %126, %127"                        \
  "}"

// D (64 x 64, fp32 registers) += A·B, A (64 x 16) and B (64 x 16) both
// K-major in 128-byte swizzled shared memory; acc = 0 overwrites D
#define SM90_MMA_SS_N64(TY)                                               \
  asm volatile("{\n.reg .pred p;\n"                                       \
               "setp.ne.b32 p, %34, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " " SM90_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"          \
               : SM90_ACC32(d, 0)                                         \
               : "l"(a), "l"(b), "r"(acc))
template <typename T = bf16>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int acc) {
  if constexpr (std::is_same<T, __half>::value) {
    SM90_MMA_SS_N64("f16");
  } else {
    SM90_MMA_SS_N64("bf16");
  }
}
#undef SM90_MMA_SS_N64

// D (64 x 64, fp32 registers) += A·B, A (64 x 16) in registers (the
// accumulator layout, packed in pairs), B (16 x 64) MN-major in 128-byte
// swizzled shared memory
#define SM90_MMA_RS_N64(TY)                                               \
  asm volatile("{\n.reg .pred p;\n"                                       \
               "setp.ne.b32 p, %37, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " " SM90_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;" \
               "\n}\n"                                                    \
               : SM90_ACC32(d, 0)                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                 "r"(1))
template <typename T = bf16>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (std::is_same<T, __half>::value) {
    SM90_MMA_RS_N64("f16");
  } else {
    SM90_MMA_RS_N64("bf16");
  }
}
#undef SM90_MMA_RS_N64

// D (64 x 256, fp32 registers) += A·B, A (64 x 16) and B (16 x 256) both
// MN-major in 128-byte swizzled shared memory (A's rows of 64 M-values,
// B's four 64-column boxes LBO apart): the transpose bits of both set
#define SM90_MMA_SS_N256_TT(TY)                                           \
  asm volatile("{\n.reg .pred p;\n"                                       \
               "setp.ne.b32 p, %130, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY   \
               " " SM90_REGS128 ", %128, %129, p, 1, 1, 1, 1;\n}\n"       \
               : SM90_ACC32(d, 0), SM90_ACC32(d, 32), SM90_ACC32(d, 64),  \
                 SM90_ACC32(d, 96)                                        \
               : "l"(a), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void mma_ss_n256_tt(float (&d)[128], uint64_t a,
                                               uint64_t b, int acc) {
  if constexpr (std::is_same<T, __half>::value) {
    SM90_MMA_SS_N256_TT("f16");
  } else {
    SM90_MMA_SS_N256_TT("bf16");
  }
}
#undef SM90_MMA_SS_N256_TT

#undef SM90_REGS128
#undef SM90_REGS32
#undef SM90_ACC32
#undef SM90_ACC8

// --- tensor maps (host) ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched from the driver
// through the runtime, so no library links -lcuda
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

template <typename T> constexpr CUtensorMapDataType map_dtype() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A RANK-dimensional map over 16-bit elements of T: dims innermost first,
// strides (bytes) of dims 1.., boxes of box[] elements whose inner extent is
// one 64-column box, 128-byte swizzled; what lies past the tensor's edge
// reads as zeros. False if the driver refuses the map.
template <typename T, int RANK>
bool encode_map(CUtensorMap* m, const void* base, const uint64_t (&dims)[RANK],
                const uint64_t (&strides)[RANK - 1],
                const uint32_t (&box)[RANK]) {
  const EncodeTiled enc = encoder();
  cuuint64_t dim[RANK], stride[RANK > 1 ? RANK - 1 : 1];
  cuuint32_t bx[RANK], step[RANK];
  for (int i = 0; i < RANK; ++i) {
    dim[i] = dims[i];
    bx[i] = box[i];
    step[i] = 1;
    if (i + 1 < RANK) stride[i] = strides[i];
  }
  return enc && enc(m, map_dtype<T>(), RANK, const_cast<void*>(base), dim,
                    stride, bx, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's streaming multiprocessors (device 0 of the current context)
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 132;
    return v;
  }();
  return n;
}

// blocks of `kernel` the whole card holds at once (its occupancy an SM
// times the SMs), at least 1
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    per_sm = 1;
  return max(1, per_sm) * sm_count();
}

}  // namespace sm90
