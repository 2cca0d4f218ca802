// Flash attention forward for Hopper (sm_90a): non-causal, unmasked
// softmax(q k^T / sqrt(d)) v with an online softmax, f32 accumulation and
// the output in the input type.
//
// Replaces consolver_tpu/kernels/flash_attention.py::_flash_kernel and its
// wrapper flash_attention (the Pallas TPU kernel). It is not a block-by-block
// copy: the TPU kernel walks a sequential grid over whole-KV VMEM blocks
// after padding D to 128 and S to the block size in device memory; here one
// thread block owns one (batch, head, q-tile), streams K/V tiles through
// shared memory, reads q/k/v in their [B, S, H, D] layout through strides,
// and masks the ragged Sq/Sk tails and zero-fills head dims up to the tile
// width (40 -> 48, 80, 160, 512) in shared memory only.
//
// What bounds it: the work is 4*B*H*Sq*Sk*d operations against
// (|q| + |k| + |v| + |o|) bytes. The self-attentions that carry the time on
// the SD-1.5 path (S = 4096 and 1024 in the UNet, the VAE's single-head
// d = 512 over 4096 tokens) do 500 to 2,000 operations per byte, above
// the card's ~295, so the kernel is compute-bound there; only the 77-key
// cross-attentions and the S <= 256 levels sit below the line (PERF.md has
// each shape's bound, from chip_smoke.py). This first version
// computes with plain f32 FMAs from shared memory (no tensor cores): each
// thread keeps a register micro-tile of RQ rows x CK scores and RQ rows x
// DP/16 output columns, the S tile never leaves the SM, and row strides of
// DP + 1 floats keep the column reads free of bank conflicts. Moving both
// products to wgmma/mma.sync tensor-core instructions is the next step.
//
// C interface (route: nvcc -> shared library -> ctypes):
//   consolver_flash_attention_forward(...) returns cudaGetLastError() after
//   the launch (0 = success), or -1 for a head dim / dtype it does not take.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params : Strides {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, sk, d;
  float scale_log2;  // (1 / sqrt(d)) * log2(e): scores go through exp2
};

// Stages rows [row0, row0 + ROWS) of one (batch, head) slice into shared
// memory as f32 with row stride LD, zero-filling rows >= n and columns >= d.
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long long row_stride,
                                           int row0, int n, int d, float mul) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n && c < d) x = to_float<T>(src[row * row_stride + c]) * mul;
    dst[r * LD + c] = x;
  }
}

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int CK = BK / 16;  // key columns per thread
  constexpr int CD = DP / 16;  // output columns per thread
  constexpr int LD = DP + 1;   // odd strides: column reads hit distinct banks
  constexpr int LP = BK + 1;
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DP % 16 == 0, "tile sizes");

  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][LD] q tile, pre-scaled
  float* kvs = qs + BQ * LD;   // [BK][LD] K tile, then V tile
  float* ps = kvs + BK * LD;   // [BQ][LP] probabilities of the tile

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage_tile<T, BQ, DP, LD>(qs, qg, p.q_ss, q0, p.sq, p.d, p.scale_log2);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    __syncthreads();  // q staged; the previous V tile is no longer read
    stage_tile<T, BK, DP, LD>(kvs, kg, p.k_ss, k0, p.sk, p.d, 1.f);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = kvs[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax over this tile. The 16 threads sharing a row are the
    // 16 lanes of one half-warp, so xor shuffles below 16 reduce a row.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        if (k0 + tx + 16 * j >= p.sk) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < CK; ++j) ps[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
    }

    __syncthreads();  // every thread is done with the K tile
    stage_tile<T, BK, DP, LD>(kvs, vg, p.v_ss, k0, p.sk, p.d, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = kvs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) og[row * p.o_ss + col] = from_float<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int DP>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  // Tiles per padded head dim, sized so the f32 tiles fit the 227 KB of
  // shared memory a block may opt into (d = 512: 135.5 KB).
  constexpr int BQ = DP <= 256 ? 64 : 32;
  constexpr int BK = DP <= 160 ? 64 : 32;
  constexpr int smem = (BQ * (DP + 1) + BK * (DP + 1) + BQ * (BK + 1)) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DP, BQ, BK>;
  if constexpr (smem > 48 * 1024) {
    static std::atomic<unsigned long long> opted_in{0};
    if (int rc = opt_in_smem(kernel, smem, opted_in)) return rc;
  }
  const dim3 grid((p.sq + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, batch, heads, stream);
  if (p.d <= 48) return launch<T, 48>(p, batch, heads, stream);
  if (p.d <= 64) return launch<T, 64>(p, batch, heads, stream);
  if (p.d <= 80) return launch<T, 80>(p, batch, heads, stream);
  if (p.d <= 128) return launch<T, 128>(p, batch, heads, stream);
  if (p.d <= 160) return launch<T, 160>(p, batch, heads, stream);
  if (p.d <= 256) return launch<T, 256>(p, batch, heads, stream);
  if (p.d <= 512) return launch<T, 512>(p, batch, heads, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements;
// the head dim must be contiguous (stride 1).
extern "C" int consolver_flash_attention_forward(
    int dtype, const void* q, const void* k, const void* v, void* o, int batch, int heads,
    int sq, int sk, int d, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, void* stream) {
  if (d < 1 || d > 512 || sk < 1 || sq < 1) return -1;
  Params p{{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh},
           q, k, v, o, sq, sk, d, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_for_dim<float>(p, batch, heads, s);
    case 1: return launch_for_dim<__half>(p, batch, heads, s);
    case 2: return launch_for_dim<__nv_bfloat16>(p, batch, heads, s);
    default: return -1;
  }
}
