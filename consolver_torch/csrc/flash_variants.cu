// The three flash-attention variants of the FLUX-Kontext probe for Hopper
// (sm_90a): bf16 dots with the KV mask, bf16 dots with q pre-scaled and no
// mask, and int8 dots with probabilities on a /127 grid.
//
// Replaces the Pallas TPU kernels of scripts/probe_flash_variants.py:
//   variant 0 (bf16)   <- _bf16_kernel / flash_bf16    (:38, :70)
//   variant 1 (nomask) <- _nomask_kernel / flash_nomask (:275, :307)
//   variant 2 (int8)   <- _int8_kernel / flash_int8    (:108, :148)
//
// Semantics are those of the TPU kernels, defined per chunk of block_k keys:
// the running max that p is taken against is the max through the end of the
// current chunk. So the kernel, which tiles a chunk into 64-key tiles,
// first writes the whole chunk's scores (64 rows x block_k, f32) to shared
// memory while it takes their row max, then turns them into p in place, and
// only then streams V. bf16/nomask: s = (q.k) * scale (nomask: q scaled in
// f32 and rounded to bf16 while staged, s unscaled), cols >= Sk at -1e30,
// p = exp(s - m), l += sum(p) in f32, acc += bf16(p) @ v. int8: s =
// int32(qq.kq) * (qs * scale) * ks, pq = rint(p * 127) (half to even, as
// jnp.round), l += sum(pq) * (1/127) starting from 1e-20 (XLA compiles the
// TPU kernel's "/ 127" into that multiply), acc += int32(pq.vq) * vs. The
// int8 path uses __fmul_rn/__fadd_rn so that no multiply-add is contracted:
// with the same expf it is bit-equal to the plain torch version on the
// card, whose integer products are exact in f32.
//
// What bounds it: 4*B*H*Sq*Sk*d operations over |q|+|k|+|v|+|o| bytes, about
// 2,200 operations per byte at the FLUX serving shape [1, 8704, 24, 128] in
// bf16 (and twice that in int8), far above the card's ~295: compute-bound on
// tensor cores. This first version computes with FMAs (bf16 products
// exactly in f32) and dp4a (int8), not tensor cores: each thread keeps a
// 4 x 4 score and 4 x 8 output register tile, a block owns 64 query rows of
// one (batch, head), and the chunk's score tile (128 KB at block_k = 512)
// limits it to one block per SM. Moving the products to mma.sync / wgmma is
// the next step.
//
// C interface (route: nvcc -> shared library -> ctypes):
//   consolver_flash_variant_forward(...) returns cudaGetLastError() after the
//   launch (0 = success), or -1 for a shape / dtype / variant it does not take.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int BQ = 64;         // query rows per block
constexpr int KT = 64;         // keys per shared-memory tile
constexpr int DP = 128;        // head dim, zero-filled up to it
constexpr int RQ = BQ / 16;    // rows per thread
constexpr int CT = KT / 16;    // tile columns per thread
constexpr int CD = DP / 16;    // output columns per thread
constexpr int LD = DP + 1;     // f32 row stride: column reads hit distinct banks
constexpr int QW = DP / 4 + 1; // int32 words per int8 row (4 channels a word)
constexpr int VW = KT / 4 + 1; // words per channel of a transposed int8 V tile
constexpr int kMaxBlockK = 512;
constexpr float kNegInf = -1e30f;
constexpr float kInv127 = 1.f / 127.f;  // XLA turns "/ 127" into "* (1/127)"

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Params : Strides {
  const void* q;
  const void* k;
  const void* v;
  const float* qs;  // int8: [B, Sq, H] per-token q scales
  const float* ks;  // int8: [B, Sk, H] per-token k scales
  const float* vs;  // int8: [B, H, D] v_scale / 127
  void* o;
  int heads, sq, sk, d, block_k;
  float scale;  // 1 / sqrt(d)
};

// Rows [row0, row0 + ROWS) of one (batch, head) slice into shared memory as
// f32 (row stride LD), zero-filling rows >= n and columns >= d.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, long long row_stride,
                                          int row0, int n, int d) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    const int row = row0 + r;
    dst[r * LD + c] = (row < n && c < d) ? to_float<T>(src[row * row_stride + c]) : 0.f;
  }
}

// Rows of int8 into words of 4 consecutive channels (row stride QW words).
template <int ROWS>
__device__ __forceinline__ void stage_i8_rows(int* dst, const signed char* src,
                                              long long row_stride, int row0, int n, int d) {
  for (int i = threadIdx.x; i < ROWS * (DP / 4); i += kThreads) {
    const int r = i / (DP / 4);
    const int w = i - r * (DP / 4);
    const int row = row0 + r;
    unsigned int word = 0;
    if (row < n) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = 4 * w + b;
        const unsigned int byte =
            c < d ? static_cast<unsigned char>(src[row * row_stride + c]) : 0u;
        word |= byte << (8 * b);
      }
    }
    dst[r * QW + w] = static_cast<int>(word);
  }
}

// A V tile of int8 transposed into words of 4 consecutive keys per channel
// (dst[c * VW + kk / 4]), zero-filling keys >= n and channels >= d.
__device__ __forceinline__ void stage_i8_vt(int* dst, const signed char* src,
                                            long long row_stride, int row0, int n, int d) {
  for (int i = threadIdx.x; i < (KT / 4) * DP; i += kThreads) {
    const int w = i / DP;
    const int c = i - w * DP;
    unsigned int word = 0;
    if (c < d) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int row = row0 + 4 * w + b;
        const unsigned int byte =
            row < n ? static_cast<unsigned char>(src[row * row_stride + c]) : 0u;
        word |= byte << (8 * b);
      }
    }
    dst[c * VW + w] = static_cast<int>(word);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename V>
__device__ __forceinline__ V row_sum16(V x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Variants 0 (bf16) and 1 (nomask). T is the type of q, k, v and the output.
template <typename T, bool kPrescaleQ>
__global__ void __launch_bounds__(kThreads) bf16_variant_kernel(Params p) {
  extern __shared__ float smem[];
  const int lps = p.block_k + 1;  // score row stride
  float* qt = smem;               // [BQ][LD] q tile
  float* kvt = qt + BQ * LD;      // [KT][LD] K tile, then V tile
  float* sc = kvt + KT * LD;      // [BQ][lps] the chunk's scores, then bf16(p)

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage_f32<T, BQ>(qt, qg, p.q_ss, q0, p.sq, p.d);
  if (kPrescaleQ) {
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * DP; i += kThreads) {
      float* x = &qt[(i / DP) * LD + i % DP];
      *x = round_bf16(*x * p.scale);  // (q.astype(f32) * scale).astype(bf16)
    }
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int c0 = 0; c0 < p.sk; c0 += p.block_k) {
    const int ncols = min(p.block_k, ((p.sk - c0 + KT - 1) / KT) * KT);
    float mx[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) mx[i] = kNegInf;

    // 1. the chunk's scores and their row max
    for (int t0 = 0; t0 < ncols; t0 += KT) {
      __syncthreads();  // the previous K / V tile is no longer read
      stage_f32<T, KT>(kvt, kg, p.k_ss, c0 + t0, p.sk, p.d);
      __syncthreads();
      float s[RQ][CT];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DP; ++c) {
        float qv[RQ], kv[CT];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qv[i] = qt[(ty + 16 * i) * LD + c];
#pragma unroll
        for (int j = 0; j < CT; ++j) kv[j] = kvt[(tx + 16 * j) * LD + c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int col = t0 + tx + 16 * j;
          float x = kPrescaleQ ? s[i][j] : s[i][j] * p.scale;
          if (c0 + col >= p.sk) x = kNegInf;
          sc[(ty + 16 * i) * lps + col] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    }

    // 2. p in place (each thread reads back only its own columns), l, alpha
    float alpha[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float m_new = fmaxf(m[i], row_max16(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
      for (int col = tx; col < ncols; col += 16) {
        float* x = &sc[(ty + 16 * i) * lps + col];
        const float pr = expf(*x - m_new);
        rs += pr;
        *x = round_bf16(pr);
      }
      l[i] = l[i] * alpha[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha[i];
    }

    // 3. acc += bf16(p) @ V over the chunk's tiles
    for (int t0 = 0; t0 < ncols; t0 += KT) {
      __syncthreads();  // p written; the K tile is no longer read
      stage_f32<T, KT>(kvt, vg, p.v_ss, c0 + t0, p.sk, p.d);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float pv[RQ], vv[CD];
#pragma unroll
        for (int i = 0; i < RQ; ++i) pv[i] = sc[(ty + 16 * i) * lps + t0 + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) vv[c] = kvt[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) og[row * p.o_ss + col] = from_float<T>(acc[i][c] / l[i]);
    }
  }
}

// Variant 2 (int8). q, k, v are int8 [B, S, H, D]; T is the output type.
template <typename T>
__global__ void __launch_bounds__(kThreads) int8_variant_kernel(Params p) {
  extern __shared__ float smem[];
  const int lps = p.block_k + 1;
  const int pws = p.block_k / 4 + 1;  // words per row of pq
  float* sc = smem;                                        // [BQ][lps] scores
  int* qw = reinterpret_cast<int*>(sc + BQ * lps);         // [BQ][QW] q words
  int* kw = qw + BQ * QW;                                  // [KT][QW] k words
  int* vt = kw + KT * QW;                                  // [DP][VW] V tile, transposed
  int* pw = vt + DP * VW;                                  // [BQ][pws] pq, 4 keys a word
  signed char* pb = reinterpret_cast<signed char*>(pw);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const signed char* qg = static_cast<const signed char*>(p.q) + b * p.q_sb + h * p.q_sh;
  const signed char* kg = static_cast<const signed char*>(p.k) + b * p.k_sb + h * p.k_sh;
  const signed char* vg = static_cast<const signed char*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ksg = p.ks + static_cast<long long>(b) * p.sk * p.heads + h;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage_i8_rows<BQ>(qw, qg, p.q_ss, q0, p.sq, p.d);

  float qmul[RQ], vs[CD], m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    // qs * scale, as the TPU kernel forms it before scaling the scores
    qmul[i] = row < p.sq
        ? __fmul_rn(p.qs[(static_cast<long long>(b) * p.sq + row) * p.heads + h], p.scale)
        : 0.f;
    m[i] = kNegInf;
    l[i] = 1e-20f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < CD; ++c) {
    const int col = tx + 16 * c;
    vs[c] = col < p.d ? p.vs[(static_cast<long long>(b) * p.heads + h) * p.d + col] : 0.f;
  }

  for (int c0 = 0; c0 < p.sk; c0 += p.block_k) {
    const int ncols = min(p.block_k, ((p.sk - c0 + KT - 1) / KT) * KT);
    float mx[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) mx[i] = kNegInf;

    // 1. the chunk's scores and their row max
    for (int t0 = 0; t0 < ncols; t0 += KT) {
      __syncthreads();
      stage_i8_rows<KT>(kw, kg, p.k_ss, c0 + t0, p.sk, p.d);
      __syncthreads();
      int s[RQ][CT];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = 0;
#pragma unroll 4
      for (int w = 0; w < DP / 4; ++w) {
        int qv[RQ], kv[CT];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qv[i] = qw[(ty + 16 * i) * QW + w];
#pragma unroll
        for (int j = 0; j < CT; ++j) kv[j] = kw[(tx + 16 * j) * QW + w];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) s[i][j] = __dp4a(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = t0 + tx + 16 * j;
        const bool valid = c0 + col < p.sk;
        const float kscale = valid ? ksg[static_cast<long long>(c0 + col) * p.heads] : 0.f;
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          float x = __fmul_rn(__fmul_rn(static_cast<float>(s[i][j]), qmul[i]), kscale);
          if (!valid) x = kNegInf;
          sc[(ty + 16 * i) * lps + col] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }

    // 2. pq = rint(p * 127) against the chunk's max, l from the pq
    float alpha[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float m_new = fmaxf(m[i], row_max16(mx[i]));
      alpha[i] = expf(__fsub_rn(m[i], m_new));
      int qsum = 0;
      for (int col = tx; col < ncols; col += 16) {
        const float pr = expf(__fsub_rn(sc[(ty + 16 * i) * lps + col], m_new));
        const int pq = static_cast<int>(rintf(__fmul_rn(pr, 127.f)));
        qsum += pq;
        pb[(ty + 16 * i) * pws * 4 + col] = static_cast<signed char>(pq);
      }
      const float l_part = __fmul_rn(static_cast<float>(row_sum16(qsum)), kInv127);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), l_part);
      m[i] = m_new;
    }

    // 3. acc = acc * alpha + int32(pq . vq) * vs over the chunk
    int pv[RQ][CD];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) pv[i][c] = 0;
    for (int t0 = 0; t0 < ncols; t0 += KT) {
      __syncthreads();  // pq written; the previous V tile is no longer read
      stage_i8_vt(vt, vg, p.v_ss, c0 + t0, p.sk, p.d);
      __syncthreads();
#pragma unroll 4
      for (int w = 0; w < KT / 4; ++w) {
        int pvw[RQ], vvw[CD];
#pragma unroll
        for (int i = 0; i < RQ; ++i) pvw[i] = pw[(ty + 16 * i) * pws + t0 / 4 + w];
#pragma unroll
        for (int c = 0; c < CD; ++c) vvw[c] = vt[(tx + 16 * c) * VW + w];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) pv[i][c] = __dp4a(pvw[i], vvw[c], pv[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha[i]),
                              __fmul_rn(static_cast<float>(pv[i][c]), vs[c]));
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) og[row * p.o_ss + col] = from_float<T>(__fdiv_rn(acc[i][c], l[i]));
    }
  }
}

constexpr int bf16_smem(int block_k) { return (BQ * LD + KT * LD + BQ * (block_k + 1)) * 4; }
constexpr int int8_smem(int block_k) {
  return (BQ * (block_k + 1) + BQ * QW + KT * QW + DP * VW + BQ * (block_k / 4 + 1)) * 4;
}

// Each kernel opts in to the largest dynamic shared memory any block_k needs.
template <typename T>
int launch(int variant, const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, batch);
  if (variant == 2) {
    static std::atomic<unsigned long long> opted{0};
    auto kernel = int8_variant_kernel<T>;
    if (int rc = opt_in_smem(kernel, int8_smem(kMaxBlockK), opted)) return rc;
    kernel<<<grid, kThreads, int8_smem(p.block_k), stream>>>(p);
  } else if (variant == 1) {
    static std::atomic<unsigned long long> opted{0};
    auto kernel = bf16_variant_kernel<T, true>;
    if (int rc = opt_in_smem(kernel, bf16_smem(kMaxBlockK), opted)) return rc;
    kernel<<<grid, kThreads, bf16_smem(p.block_k), stream>>>(p);
  } else {
    static std::atomic<unsigned long long> opted{0};
    auto kernel = bf16_variant_kernel<T, false>;
    if (int rc = opt_in_smem(kernel, bf16_smem(kMaxBlockK), opted)) return rc;
    kernel<<<grid, kThreads, bf16_smem(p.block_k), stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 = bf16, 1 = nomask, 2 = int8. dtype (of q/k/v for variants 0
// and 1, of the output for all): 0 = float32, 1 = float16, 2 = bfloat16.
// Strides are in elements; the head dim must be contiguous. qs/ks/vs are
// read by variant 2 only ([B, S, H], [B, S, H], [B, H, D], contiguous f32).
extern "C" int consolver_flash_variant_forward(
    int variant, int dtype, const void* q, const void* k, const void* v, const void* qs,
    const void* ks, const void* vs, void* o, int batch, int heads, int sq, int sk, int d,
    int block_k, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  if (variant < 0 || variant > 2 || d < 1 || d > DP || sq < 1 || sk < 1) return -1;
  if (block_k < KT || block_k > kMaxBlockK || block_k % KT != 0) return -1;
  if (variant == 2 && (qs == nullptr || ks == nullptr || vs == nullptr)) return -1;
  Params p{{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh},
           q, k, v, static_cast<const float*>(qs), static_cast<const float*>(ks),
           static_cast<const float*>(vs), o, heads, sq, sk, d, block_k, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(variant, p, batch, s);
    case 1: return launch<__half>(variant, p, batch, s);
    case 2: return launch<__nv_bfloat16>(variant, p, batch, s);
    default: return -1;
  }
}
