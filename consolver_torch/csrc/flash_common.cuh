// Helpers shared by the flash-attention kernels of this directory
// (flash_attention.cu, flash_variants.cu): conversions between the storage
// types and f32, the [B, S, H, D] stride layout the C interfaces pass, and
// the once-per-device opt-in to more than 48 KB of dynamic shared memory.
// Each source is its own library, so this header is included once per build.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

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

}  // namespace
