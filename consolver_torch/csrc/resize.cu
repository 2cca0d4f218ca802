// The edit's reference image on the card: the centre crop of the imaging
// library's 8-bit Lanczos resample (the short side scaled to `size`), mapped
// to float32 [-1, 1].
//
// Replaces no TPU kernel: the JAX package resizes references on the host
// with PIL, and the port's host path (utils/resize.py::lanczos_resize, then
// data/edit_prep.py::center_crop_resize) follows it bit for bit in numpy.
// That host path held the card idle between edits, so the same arithmetic
// runs here, on the crop window only.
//
// The function is the host's, to the bit. Each output pixel depends only on
// its own fixed-point coefficients (22 fraction bits, built on the host by
// utils/resize.py::_coefficients for the window's outputs) and on the uint8
// values of its taps:
//
//   acc = (1 << 21) + sum_k w[k] * u[first + k]     (int32, as the host's)
//   out = clip(acc >> 22, 0, 255)                     (arithmetic shift)
//
// with tap indices past the input clamped to its last pixel, where the
// weight is 0, as the host's np.take does. The horizontal pass runs first
// and rounds to uint8, then the vertical pass, which writes
// (float(u) / 255) * 2 - 1 with IEEE division, multiplication and
// subtraction (__fdiv_rn, __fmul_rn, __fsub_rn, so that no flag or FMA
// contraction changes a bit). An axis that keeps its size is not resampled:
// the horizontal pass is skipped (the vertical pass reads the source at the
// crop's column offset), or the vertical pass reads its rows unfiltered.
//
// What bounds it: bytes. Per edit about 3 MB of uint8 in, a uint8 scratch of
// [in_h, size, 3] written and read once, and 12.6 MB of float32 out, against
// 2 x 7 integer multiply-adds per output byte at the upscales the edit
// serves (19 and more taps on a downscale). One thread per output pixel (its
// three channels), consecutive threads on consecutive pixels of a row, so
// that loads and stores of a warp fall on neighbouring bytes; a grid-stride
// loop over the pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPrecisionBits = 22;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ int clip8(int acc) {
  return min(max(acc >> kPrecisionBits, 0), 255);
}

__device__ __forceinline__ float to_signed_unit(int u) {
  return __fsub_rn(__fmul_rn(__fdiv_rn(static_cast<float>(u), 255.0f), 2.0f), 1.0f);
}

// src [rows, in_w, 3] uint8 -> dst [rows, size, 3] uint8: output column c
// reads first[c] .. first[c] + taps - 1 with weights[c * taps + k].
__global__ void lanczos_rows_kernel(const uint8_t* __restrict__ src, int rows, int in_w,
                                    const int* __restrict__ first,
                                    const int* __restrict__ weights, int taps, int size,
                                    uint8_t* __restrict__ dst) {
  const long long n = static_cast<long long>(rows) * size;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long y = i / size;
    const int c = static_cast<int>(i - y * size);
    const uint8_t* row = src + y * in_w * 3;
    const int* w = weights + static_cast<long long>(c) * taps;
    const int x0 = first[c];
    int a0 = 1 << (kPrecisionBits - 1), a1 = a0, a2 = a0;
    for (int k = 0; k < taps; ++k) {
      const uint8_t* p = row + 3 * min(x0 + k, in_w - 1);
      const int wk = w[k];
      a0 += static_cast<int>(p[0]) * wk;
      a1 += static_cast<int>(p[1]) * wk;
      a2 += static_cast<int>(p[2]) * wk;
    }
    uint8_t* o = dst + 3 * i;
    o[0] = static_cast<uint8_t>(clip8(a0));
    o[1] = static_cast<uint8_t>(clip8(a1));
    o[2] = static_cast<uint8_t>(clip8(a2));
  }
}

// src rows of `row_pixels` pixels, read from column `col0` on -> out
// [size, size, 3] float32 in [-1, 1]. With `first` null the rows are read
// unfiltered from row `top` on; else output row r reads rows first[r] ..
// first[r] + taps - 1 with weights[r * taps + k].
__global__ void lanczos_cols_kernel(const uint8_t* __restrict__ src, int in_h, int row_pixels,
                                    int col0, const int* __restrict__ first,
                                    const int* __restrict__ weights, int taps, int top, int size,
                                    float* __restrict__ out) {
  const long long n = static_cast<long long>(size) * size;
  const long long stride = 3LL * row_pixels;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / size);
    const int c = static_cast<int>(i - static_cast<long long>(r) * size);
    const uint8_t* column = src + 3LL * (col0 + c);
    int u0, u1, u2;
    if (first == nullptr) {
      const uint8_t* p = column + (top + r) * stride;
      u0 = p[0];
      u1 = p[1];
      u2 = p[2];
    } else {
      const int* w = weights + static_cast<long long>(r) * taps;
      const int y0 = first[r];
      int a0 = 1 << (kPrecisionBits - 1), a1 = a0, a2 = a0;
      for (int k = 0; k < taps; ++k) {
        const uint8_t* p = column + min(y0 + k, in_h - 1) * stride;
        const int wk = w[k];
        a0 += static_cast<int>(p[0]) * wk;
        a1 += static_cast<int>(p[1]) * wk;
        a2 += static_cast<int>(p[2]) * wk;
      }
      u0 = clip8(a0);
      u1 = clip8(a1);
      u2 = clip8(a2);
    }
    float* o = out + 3 * i;
    o[0] = to_signed_unit(u0);
    o[1] = to_signed_unit(u1);
    o[2] = to_signed_unit(u2);
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// src [in_h, in_w, 3] uint8 -> out [size, size, 3] float32, both contiguous
// on the current device. col_first / col_weights ([size], [size, col_taps]
// int32): the horizontal pass over the crop's columns, into scratch
// [in_h, size, 3] uint8; both null where the width keeps its size, and then
// the crop starts at column `left`. row_first / row_weights likewise for the
// vertical pass over the crop's rows; null where the height keeps its size,
// and then the crop starts at row `top`. Returns 0, -1 for arguments the
// kernels do not take, or the CUDA error of a launch.
extern "C" int consolver_resize_center_crop(const void* src, int in_h, int in_w, void* scratch,
                                            const int* col_first, const int* col_weights,
                                            int col_taps, int left, const int* row_first,
                                            const int* row_weights, int row_taps, int top,
                                            int size, void* out, void* stream) {
  if (src == nullptr || out == nullptr || in_h < 1 || in_w < 1 || size < 1) return -1;
  const bool by_cols = col_first != nullptr;
  const bool by_rows = row_first != nullptr;
  if (by_cols && (col_weights == nullptr || scratch == nullptr || col_taps < 1)) return -1;
  if (!by_cols && (left < 0 || left + size > in_w)) return -1;
  if (by_rows && (row_weights == nullptr || row_taps < 1)) return -1;
  if (!by_rows && (top < 0 || top + size > in_h)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rows_src = static_cast<const uint8_t*>(src);
  int row_pixels = in_w, col0 = left;
  if (by_cols) {
    lanczos_rows_kernel<<<blocks_for(static_cast<long long>(in_h) * size), kThreads, 0, s>>>(
        rows_src, in_h, in_w, col_first, col_weights, col_taps, size,
        static_cast<uint8_t*>(scratch));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rows_src = static_cast<const uint8_t*>(scratch);
    row_pixels = size;
    col0 = 0;
  }
  lanczos_cols_kernel<<<blocks_for(static_cast<long long>(size) * size), kThreads, 0, s>>>(
      rows_src, in_h, row_pixels, col0, by_rows ? row_first : nullptr, row_weights, row_taps,
      top, size, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
