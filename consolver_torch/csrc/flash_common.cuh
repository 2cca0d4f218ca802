// Helpers shared by the flash-attention kernels of this directory
// (flash_attention.cu, flash_variants.cu): conversions between the storage
// types and f32, the [B, S, H, D] stride layout the C interfaces pass, the
// once-per-device opt-in to more than 48 KB of dynamic shared memory, and
// what the tensor-core kernels share: the PTX wrappers (cp.async, ldmatrix,
// mma.sync m16n8k16 bf16 and m16n8k32 s8) and the staging of bf16 rows into
// shared tiles.
// Each source is its own library, so this header is included once per
// build.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of q, k, v and the output over (batch, sequence, head);
// the head dim is contiguous.
struct Strides {
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
};

// Opts `kernel` in to `bytes` of dynamic shared memory once per device: the
// attribute stays set on the function, so later launches skip
// cudaFuncSetAttribute. `opted_in` holds one bit per device, one static per
// kernel.
template <typename Kernel>
int opt_in_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>& opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.fetch_or(bit, std::memory_order_release);
  }
  return 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each; int8 tiles
// read the same bytes); lane l addresses row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums. Fragments of
// lane (g = lane / 4, t = lane % 4): a0 (row g, cols 2t, 2t+1), a1 (row g+8),
// a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9); b0 (k 2t, 2t+1,
// col g), b1 (k 2t+8, 2t+9); c0 c1 (row g, cols 2t, 2t+1), c2 c3 (row g+8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 sums (exact). Fragments
// of lane (g = lane / 4, t = lane % 4), 4 bytes a register: a0 (row g, k
// 4t..4t+3), a1 (row g+8), a2 (row g, k 16+4t..19+4t), a3 (row g+8, k
// 16+4t..); b0 (k 4t..4t+3, col g), b1 (k 16+4t..); c as in mma_bf16.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Rows [row0, row0 + ROWS) of one (batch, head) slice into a shared tile of
// row stride DP + 8 (the 8 rows an ldmatrix reads fall on distinct banks);
// rows >= n and columns >= d are zeros. kVec: cp.async 16-byte copies (rows
// 16-byte aligned, d % 8 == 0); else element by element. NT threads share it.
template <int ROWS, int DP, int NT, bool kVec>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long row_stride,
                                           int row0, int n, int d) {
  constexpr int LDS = DP + 8;
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < ROWS * (DP / 8); i += NT) {
      const int r = i / (DP / 8);
      const int c = (i - r * (DP / 8)) * 8;
      const int row = row0 + r;
      const bool full = row < n && c < d;
      cp_async16(dst + r * LDS + c, full ? src + row * row_stride + c : src, full ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP;
      const int c = i - r * DP;
      const int row = row0 + r;
      dst[r * LDS + c] = (row < n && c < d) ? src[row * row_stride + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// cp.async 16-byte copies need every row start 16-byte aligned; strides are
// in elements of elem_bytes (2: bf16, 1: int8).
inline bool rows_aligned(const void* ptr, long long sb, long long ss, long long sh,
                         int elem_bytes = 2) {
  const long long per16 = 16 / elem_bytes;
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 && sb % per16 == 0 &&
         ss % per16 == 0 && sh % per16 == 0;
}

}  // namespace
