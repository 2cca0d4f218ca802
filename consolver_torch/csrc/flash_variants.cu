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
// current chunk. The kernels tile a chunk into 64-key tiles and take the
// chunk's row max before any p of it (the FMA kernel by writing the chunk's
// scores, 64 rows x block_k f32, to shared memory, the tensor-core kernels
// by a second pass over K). bf16/nomask: s = (q.k) * scale
// (nomask: q scaled in f32 and rounded to bf16 while staged, s unscaled),
// cols >= Sk at -1e30,
// p = exp(s - m), l += sum(p) in f32, acc += bf16(p) @ v. int8: s =
// int32(qq.kq) * (qs * scale) * ks, pq = rint(p * 127) (half to even, as
// jnp.round), l += sum(pq) * (1/127) starting from 1e-20 (XLA compiles the
// TPU kernel's "/ 127" into that multiply), acc = acc * alpha + f32(int32(
// pq.vq)) * vs. The int8 kernel uses __fmul_rn/__fadd_rn so that no
// multiply-add is contracted: with the same expf it is bit-equal to the
// plain torch version on the card, whose integer products are exact in f32.
//
// What bounds it: 4*B*H*Sq*Sk*d operations over |q|+|k|+|v|+|o| bytes, about
// 2,200 operations per byte at the FLUX serving shape [1, 8704, 24, 128] in
// bf16 (and twice that in int8), far above the card's ~295: compute-bound on
// tensor cores.
//
// Routes, chosen by the type of q/k/v (the wrapper names them):
// * "mma", variants 0 and 1 with bf16 q/k/v: bf16_mma_kernel. Both products
//   on tensor cores (mma.sync m16n8k16 bf16 x bf16 -> f32, fragments by
//   ldmatrix, .trans for V). A block is 4 warps x 16 query rows. The chunk
//   max must be known before any p of the chunk, and 16 rows x 512 keys of
//   f32 scores would be 256 registers a thread, so each chunk is walked
//   twice: pass 1 computes s tile by tile and keeps only the row max
//   (reduced over the 4 lanes of a quad); pass 2 rescales acc by alpha,
//   recomputes s (the same MMAs on the same fragments: bit-identical), forms
//   p in the score registers, adds the f32 p to l and repacks bf16(p) as the
//   A fragments of the p.v MMA: the m16n8k16 C layout is the A layout, so p
//   never touches shared memory. q.k^T runs twice (1.5x the work); in
//   exchange shared memory holds only a 2-stage ring of bf16 K/V tiles
//   (68 KB; Q passes through it once into registers), which fits 3 blocks
//   per SM, and any block_k that is a multiple of 64 is taken. Tile t+1
//   arrives by cp.async 16-byte copies while tile t is multiplied (one
//   barrier per tile), zero-filled past Sq / Sk / d, so the MMAs always run
//   the full depth 128 with no branch on d; rows padded to 136 bf16 so the 8
//   rows an ldmatrix reads hit distinct banks.
//   Rows that are not 16-byte aligned (or d % 8 != 0) are staged element by
//   element by the same kernel (kVec = false).
// * "fma", variants 0 and 1 with f32 or f16 q/k/v: bf16_variant_kernel, the
//   first port. A bf16 MMA would round f32/f16 inputs and change the
//   function, so they stay on f32 FMAs (bf16 products exactly in f32): each
//   thread keeps a 4 x 4 score and 4 x 8 output register tile, a block owns
//   64 query rows of one (batch, head), and the chunk's score tile (128 KB
//   at block_k = 512) limits it to one block per SM and block_k to 512.
// * "imma", variant 2 (every output type): int8_mma_kernel. Both products
//   on int8 tensor cores (mma.sync m16n8k32 s8 x s8 -> s32, exact), 4 warps
//   x 16 query rows, two passes over each chunk as bf16_mma_kernel: pass 1
//   keeps the scaled row max, pass 2 recomputes the integer scores (bit-
//   identical), forms pq = rint(exp(s - m) * 127), sums it in int32 and runs
//   pq.v. The m16n8k32 C layout (lane t holds columns 2t, 2t+1 of an n-tile)
//   is not its A layout (k 4t..4t+3 and 16+4t..19+4t), so the K rows feeding
//   q.k^T are permuted (score_key): the four C registers of a lane, packed by
//   prmt, are then its A fragment in natural key order, with no shuffle and
//   no shared memory. pq.v sums in int32 registers across the chunk and
//   enters acc once at its end. ldmatrix has no 8-bit transpose, so the
//   wrapper hands V over transposed ([B, H, D16, Sk16]) and the k scales as
//   [B, H, Sk16] (flash_variants.py::int8_kernel_operands), with q / k
//   padded along d to a multiple of 16: every tile arrives by cp.async
//   (2-stage ring, 37,376 bytes; K rows XOR-swizzled by 16-byte chunk so the
//   permuted rows an ldmatrix reads hit distinct banks). The f32 output
//   accumulator sits in shared memory (32 KB, once per chunk), so 3 blocks
//   of 4 warps fit on an SM. Any block_k
//   that is a multiple of 64 up to 1024 is taken (beyond it pq.v may pass
//   2^24 and its f32 conversion would round). What bounds it: 1.5x the
//   function's int8 MMAs (pass 1 recomputes q.k^T) and about 22 ALU
//   instructions per score in pass 2 (conversions, two scalings, expf,
//   rint, packing), which at d = 128 outweigh the MMAs.
//
// C interface (route: nvcc -> shared library -> ctypes):
//   consolver_flash_variant_forward(...) returns cudaGetLastError() after the
//   launch (0 = success), or -1 for a shape / dtype / variant it does not take.
//   consolver_flash_mma_occupancy(...) and consolver_flash_imma_occupancy(...)
//   report the tensor-core kernels' dynamic shared memory and resident blocks
//   per SM.

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
constexpr int kMaxBlockK = 512;  // FMA route: the chunk's scores in shared memory
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
  const float* ks;  // int8: [B, H, Sk16] per-token k scales, zero-padded
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

// Variants 0 (bf16) and 1 (nomask), FMA route (f32 and f16). T is the type
// of q, k, v and the output.
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

// ---------------------------------------------------------------------------
// Tensor-core route: variants 0 and 1 with bf16 q/k/v.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;        // 4 warps x 16 query rows = BQ
constexpr int LDS = DP + 8;             // bf16 row stride of the shared tiles (272 bytes)
constexpr int kTileElems = KT * LDS;    // one 64-row tile (BQ == KT)
constexpr int kMmaSmem = 4 * kTileElems * 2;  // 2 stages x (K, V): 69,632 bytes
static_assert(BQ == KT && BQ == 16 * (kMmaThreads / 32), "one 16-row MMA slab per warp");

// One warp's 16 x 64 scores against a K tile, s[j] holding keys 8j..8j+7 in
// the C layout. The same MMAs on the same fragments in the same order, so a
// second call on one tile gives the same bits.
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const unsigned (&qf)[DP / 16][4],
                                            const bf16* kt, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const int key = (lane & 7) + ((lane >> 4) << 3);
  const int col = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {  // keys 16jp..16jp+15: two 8-key n-tiles
      unsigned b[4];
      ldmatrix_x4(b, kt + (16 * jp + key) * LDS + 16 * kk + col);
      mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }
}

// Where a block is in its walk: chunk start c0, pass (0: K for the max, 1:
// K and V for p), tile start t0 inside the chunk.
struct Cursor {
  int c0, pass, t0;
  __device__ int chunk_cols(const Params& p) const {  // the chunk's keys in whole tiles
    return min(p.block_k, ((p.sk - c0 + KT - 1) / KT) * KT);
  }
  __device__ bool last_tile(const Params& p) const { return t0 + KT >= chunk_cols(p); }
  __device__ Cursor next(const Params& p) const {
    if (!last_tile(p)) return {c0, pass, t0 + KT};
    return pass == 0 ? Cursor{c0, 1, 0} : Cursor{c0 + p.block_k, 0, 0};
  }
};

template <bool kPrescaleQ, bool kVec>
__global__ void __launch_bounds__(kMmaThreads, 3) bf16_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at tile 2s, V at 2s + 1
  // Q passes through stage 1's K slot: it is read into registers before the
  // loop's first barrier, after which the ring overwrites it.
  bf16* qtile = ring + 2 * kTileElems;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  auto issue = [&](int stage, const Cursor& c) {
    bf16* kt = ring + 2 * stage * kTileElems;
    stage_rows<KT, DP, kMmaThreads, kVec>(kt, kg, p.k_ss, c.c0 + c.t0, p.sk, p.d);
    if (c.pass == 1)
      stage_rows<KT, DP, kMmaThreads, kVec>(kt + kTileElems, vg, p.v_ss, c.c0 + c.t0, p.sk, p.d);
  };

  Cursor cur{0, 0, 0};
  stage_rows<KT, DP, kMmaThreads, kVec>(qtile, qg, p.q_ss, q0, p.sq, p.d);
  issue(0, cur);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (kPrescaleQ) {  // (q.astype(f32) * scale).astype(bf16)
    for (int i = threadIdx.x; i < BQ * DP; i += kMmaThreads) {
      bf16* x = &qtile[(i / DP) * LDS + i % DP];
      *x = __float2bfloat16_rn(__fmul_rn(__bfloat162float(*x), p.scale));
    }
    __syncthreads();
  }
  unsigned qf[DP / 16][4];  // the warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int row = 16 * warp + (lane & 7) + (((lane >> 3) & 1) << 3);
    ldmatrix_x4(qf[kk], qtile + row * LDS + 16 * kk + ((lane >> 4) << 3));
  }

  // Per thread two rows: g = lane / 4 (index 0) and g + 8 (index 1) of the
  // warp's slab; acc[j] holds output columns 8j..8j+7.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int tcol = 2 * (lane & 3);

  int stage = 0;
  while (cur.c0 < p.sk) {
    const Cursor nxt = cur.next(p);
    cp_async_wait<0>();
    __syncthreads();  // this tile has arrived; every warp is done with the other stage
    if (nxt.c0 < p.sk) issue(stage ^ 1, nxt);  // in flight while this tile is multiplied
    cp_async_commit();
    const bf16* kt = ring + 2 * stage * kTileElems;

    float s[8][4];
    tile_scores(s, qf, kt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // s = f32(q.k) * scale; columns >= Sk at -1e30. __fmul_rn: never
        // contracted into the subtraction below, so both passes see one value.
        float x = kPrescaleQ ? s[j][e] : __fmul_rn(s[j][e], p.scale);
        if (cur.c0 + cur.t0 + 8 * j + tcol + (e & 1) >= p.sk) x = kNegInf;
        s[j][e] = x;
      }

    if (cur.pass == 0) {
      if (cur.t0 == 0) mx[0] = mx[1] = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      if (cur.last_tile(p)) {  // the chunk's max: m_new, alpha; acc *= alpha
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = mx[r];
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float m_new = fmaxf(m[r], x);
          alpha[r] = expf(m[r] - m_new);
          m[r] = m_new;
          rs[r] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
      }
    } else {
      // p = exp(s - m_new); l sums the f32 p; acc += bf16(p) . v
      unsigned pf[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = expf(s[j][e] - m[e >> 1]);
          rs[e >> 1] += pr;
          s[j][e] = pr;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // C fragments of keys 16kk.. -> A fragments
        pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      const bf16* vt = kt + kTileElems;
      const int key = (lane & 7) + (((lane >> 3) & 1) << 3);
      const int col = (lane >> 4) << 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jp = 0; jp < DP / 16; ++jp) {  // output columns 16jp..16jp+15
          unsigned bv[4];
          ldmatrix_x4_trans(bv, vt + (16 * kk + key) * LDS + 16 * jp + col);
          mma_bf16(acc[2 * jp], pf[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * jp + 1], pf[kk], bv[2], bv[3]);
        }
      if (cur.last_tile(p)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = rs[r];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          l[r] = l[r] * alpha[r] + x;
        }
      }
    }
    cur = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
    if (row >= p.sq) continue;
    bf16* orow = og + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + tcol;
      if (col >= p.d) break;
      const float lo = acc[j][2 * r] / l[r];
      const float hi = acc[j][2 * r + 1] / l[r];
      if (kVec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(lo, hi);
      } else {
        orow[col] = __float2bfloat16_rn(lo);
        if (col + 1 < p.d) orow[col + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route of variant 2 (int8), every output type.
// ---------------------------------------------------------------------------

constexpr int kMaxBlockKInt8 = 1024;  // |pq.v| <= 1024 * 127^2 < 2^24: exact in f32
constexpr int kI8Row = DP;            // bytes of a K / Q row in shared memory (swizzled)
constexpr int kI8VtRow = KT + 16;     // bytes of a V^T row (one channel): 8 rows, distinct banks
constexpr int kI8KBytes = KT * kI8Row;        // 8,192
constexpr int kI8VtBytes = DP * kI8VtRow;     // 10,240
constexpr int kI8Stage = kI8KBytes + kI8VtBytes + KT * 4;  // + the tile's k scales
// The f32 output accumulator lives in shared memory (thread-private slots,
// touched once per chunk), which frees 64 registers a thread: 3 blocks of
// 4 warps fit on an SM instead of 2.
constexpr int kI8Blocks = 3;
constexpr int kI8AccBytes = BQ * DP * 4;
constexpr int kI8Smem = 2 * kI8Stage + kI8AccBytes;  // 70,144 bytes
static_assert(BQ * kI8Row <= kI8KBytes, "Q passes through one K slot");

// Score column c of n-tile j (8 keys) of a 64-key tile scores this key of
// the tile: within each 32-key group, n-tiles 0-3 take keys
// 16 (j >> 1 & 1) + 4 (c >> 1) + 2 (j & 1) + (c & 1). Lane t of a quad
// holds columns 2t, 2t+1, so the C registers of a group's four n-tiles hold
// keys 4t..4t+3 and 16+4t..19+4t of rows g and g+8: the lane's A fragment
// of the pq.v MMA, in natural key order.
__device__ __forceinline__ int score_key(int j, int c) {
  return 16 * (j >> 1) + 4 * (c >> 1) + 2 * (j & 1) + (c & 1);
}

// The 16-byte chunk that holds logical chunk c of K / Q tile row `row`: an
// XOR by row bits (0, 2, 1 ^ 3). It is a bijection on 8 consecutive rows
// (the Q fragments) and on the 8 rows one matrix of a permuted K ldmatrix
// reads (row bit 1 fixed, bits 0, 2, 3 free), so either read hits 8
// distinct 4-bank groups.
__device__ __forceinline__ int i8_chunk(int row, int c) {
  return c ^ ((row & 1) | ((row >> 1) & 2) | ((((row >> 3) ^ (row >> 1)) & 1) << 2));
}

// Rows [row0, row0 + ROWS) of int8 (dpad bytes each, 16-byte aligned) into
// a swizzled tile by cp.async; rows >= n and chunks past dpad are zeros.
template <int ROWS>
__device__ __forceinline__ void copy_i8_rows(unsigned char* dst, const signed char* src,
                                             long long row_stride, int row0, int n, int dpad) {
  for (int i = threadIdx.x; i < ROWS * (DP / 16); i += kMmaThreads) {
    const int r = i / (DP / 16);
    const int c = i % (DP / 16);
    const int row = row0 + r;
    const bool full = row < n && 16 * c < dpad;
    cp_async16(dst + r * kI8Row + 16 * i8_chunk(r, c),
               full ? src + row * row_stride + 16 * c : src, full ? 16 : 0);
  }
}

// Keys [key0, key0 + KT) of every channel of V^T (channel rows
// channel_stride bytes apart, keys zero-padded to sk16) into rows of
// kI8VtRow bytes; channels past dpad and keys past sk16 are zeros.
__device__ __forceinline__ void copy_i8_vt(unsigned char* dst, const signed char* src,
                                           long long channel_stride, int key0, int sk16,
                                           int dpad) {
  for (int i = threadIdx.x; i < DP * (KT / 16); i += kMmaThreads) {
    const int c = i / (KT / 16);
    const int k = 16 * (i % (KT / 16));
    const bool full = c < dpad && key0 + k < sk16;
    cp_async16(dst + c * kI8VtRow + k, full ? src + c * channel_stride + key0 + k : src,
               full ? 16 : 0);
  }
}

// One warp's 16 x 64 integer scores against a K tile: si[j][e] scores key
// score_key(j, 2t + (e & 1)) for row g + 8 (e >> 1). The same MMAs on the
// same fragments, so a second call on one tile gives the same integers.
__device__ __forceinline__ void tile_scores_i8(int (&si)[8][4], const unsigned (&qf)[DP / 32][4],
                                               const unsigned char* kt, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
  // Lane 8m + r addresses row r of matrix m (n-tile 2jp + (m >> 1), k half
  // m & 1): the K row that score_key puts in that column.
  const int key = 4 * ((lane >> 1) & 3) + 2 * (lane >> 4) + (lane & 1);
  const int half = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < DP / 32; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int row = 16 * jp + key;
      unsigned b[4];
      ldmatrix_x4(b, kt + row * kI8Row + 16 * i8_chunk(row, 2 * kk + half));
      mma_s8(si[2 * jp], qf[kk], b[0], b[1]);
      mma_s8(si[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }
}

// The low bytes of four registers into one, the first in the low byte.
__device__ __forceinline__ unsigned pack_s8(int b0, int b1, int b2, int b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// Variant 2: q, k int8 [B, S, H, dpad], v int8 V^T [B, H, dpad, sk16] (v_ss
// is the channel stride), ks [B, H, sk16], qs [B, Sq, H], vs [B, H, D]; T is
// the output type.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kI8Blocks) int8_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;  // stage s at s * kI8Stage: K tile, V^T tile, k scales
  // Q passes through stage 1's K slot: it is read into registers before the
  // loop's first barrier, after which the ring overwrites it.
  unsigned char* qtile = ring + kI8Stage;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dpad = (p.d + 15) & ~15;
  const int sk16 = (p.sk + 15) & ~15;
  const signed char* qg = static_cast<const signed char*>(p.q) + b * p.q_sb + h * p.q_sh;
  const signed char* kg = static_cast<const signed char*>(p.k) + b * p.k_sb + h * p.k_sh;
  const signed char* vg = static_cast<const signed char*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ksg = p.ks + (static_cast<long long>(b) * p.heads + h) * sk16;
  const float* vsg = p.vs + (static_cast<long long>(b) * p.heads + h) * p.d;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  auto issue = [&](int stage, const Cursor& c) {
    unsigned char* st = ring + stage * kI8Stage;
    const int key0 = c.c0 + c.t0;
    copy_i8_rows<KT>(st, kg, p.k_ss, key0, p.sk, dpad);
    if (threadIdx.x < KT / 4) {  // the tile's k scales, 4 keys a copy
      const int key = key0 + 4 * threadIdx.x;
      const bool full = key < sk16;
      cp_async16(st + kI8KBytes + kI8VtBytes + 16 * threadIdx.x, full ? ksg + key : ksg,
                 full ? 16 : 0);
    }
    if (c.pass == 1) copy_i8_vt(st + kI8KBytes, vg, p.v_ss, key0, sk16, dpad);
  };

  Cursor cur{0, 0, 0};
  copy_i8_rows<BQ>(qtile, qg, p.q_ss, q0, p.sq, dpad);
  issue(0, cur);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[DP / 32][4];  // the warp's 16 query rows as A fragments, 32 channels each
  {
    const int row = 16 * warp + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int kk = 0; kk < DP / 32; ++kk)
      ldmatrix_x4(qf[kk], qtile + row * kI8Row + 16 * i8_chunk(row, 2 * kk + (lane >> 4)));
  }

  // Per thread two rows: g (index 0) and g + 8 (index 1) of the warp's slab;
  // acc(j, e) and pv[j][e] hold output columns 8j + 2t + (e & 1) of row e >> 1.
  float qmul[2], m[2] = {kNegInf, kNegInf}, l[2] = {1e-20f, 1e-20f}, alpha[2] = {1.f, 1.f};
  float rmax[2] = {kNegInf, kNegInf};
  int qsum[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    // qs * scale, as the TPU kernel forms it before scaling the scores
    qmul[r] = row < p.sq
        ? __fmul_rn(p.qs[(static_cast<long long>(b) * p.sq + row) * p.heads + h], p.scale)
        : 0.f;
  }
  float* acc_s = reinterpret_cast<float*>(smem_raw + 2 * kI8Stage);
  auto acc = [&](int j, int e) -> float& { return acc_s[(4 * j + e) * kMmaThreads + threadIdx.x]; };
  int pv[DP / 8][4];  // the chunk's int32 pq.v so far
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc(j, e) = 0.f;
      pv[j][e] = 0;
    }

  int stage = 0;
  while (cur.c0 < p.sk) {
    const Cursor nxt = cur.next(p);
    cp_async_wait<0>();
    __syncthreads();  // the tile is in; no warp reads the other stage any more
    if (nxt.c0 < p.sk) issue(stage ^ 1, nxt);  // lands while this tile is multiplied
    cp_async_commit();
    const unsigned char* st = ring + stage * kI8Stage;
    const float* kss = reinterpret_cast<const float*>(st + kI8KBytes + kI8VtBytes);

    int si[8][4];
    tile_scores_i8(si, qf, st, lane);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // s = f32(int32(qq.kq)) * (qs * scale) * ks
      const float2 kscale = *reinterpret_cast<const float2*>(kss + score_key(j, 2 * t));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = __fmul_rn(__fmul_rn(static_cast<float>(si[j][e]), qmul[e >> 1]),
                            e & 1 ? kscale.y : kscale.x);
    }
    if (cur.c0 + cur.t0 + KT > p.sk) {  // keys >= Sk at -1e30
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (cur.c0 + cur.t0 + score_key(j, 2 * t + (e & 1)) >= p.sk) s[j][e] = kNegInf;
    }

    if (cur.pass == 0) {
      if (cur.t0 == 0) rmax[0] = rmax[1] = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rmax[e >> 1] = fmaxf(rmax[e >> 1], s[j][e]);
      if (cur.last_tile(p)) {  // the chunk's max: m_new and alpha
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = rmax[r];
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float m_new = fmaxf(m[r], x);
          alpha[r] = expf(__fsub_rn(m[r], m_new));
          m[r] = m_new;
        }
      }
    } else {
      // pq = rint(exp(s - m_new) * 127), half to even, summed in int32; the
      // C registers of each 32-key group are its A fragment
      int pq[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = expf(__fsub_rn(s[j][e], m[e >> 1]));
          pq[j][e] = static_cast<int>(rintf(__fmul_rn(pr, 127.f)));
          qsum[e >> 1] += pq[j][e];
        }
      unsigned pf[2][4];
#pragma unroll
      for (int kg2 = 0; kg2 < 2; ++kg2) {
        const int j0 = 4 * kg2;
        pf[kg2][0] = pack_s8(pq[j0][0], pq[j0][1], pq[j0 + 1][0], pq[j0 + 1][1]);
        pf[kg2][1] = pack_s8(pq[j0][2], pq[j0][3], pq[j0 + 1][2], pq[j0 + 1][3]);
        pf[kg2][2] = pack_s8(pq[j0 + 2][0], pq[j0 + 2][1], pq[j0 + 3][0], pq[j0 + 3][1]);
        pf[kg2][3] = pack_s8(pq[j0 + 2][2], pq[j0 + 2][3], pq[j0 + 3][2], pq[j0 + 3][3]);
      }
      const unsigned char* vt = st + kI8KBytes;
      const int ch = (lane & 7) + ((lane >> 4) << 3);
      const int kb = ((lane >> 3) & 1) << 4;
#pragma unroll
      for (int kg2 = 0; kg2 < 2; ++kg2)
#pragma unroll
        for (int jp = 0; jp < DP / 16; ++jp) {  // channels 16jp..16jp+15
          unsigned bv[4];
          ldmatrix_x4(bv, vt + (16 * jp + ch) * kI8VtRow + 32 * kg2 + kb);
          mma_s8(pv[2 * jp], pf[kg2], bv[0], bv[1]);
          mma_s8(pv[2 * jp + 1], pf[kg2], bv[2], bv[3]);
        }
      if (cur.last_tile(p)) {
        // l = l * alpha + f32(sum pq) * (1/127); acc = acc * alpha + f32(pv) * vs
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          int x = qsum[r];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), __fmul_rn(static_cast<float>(x), kInv127));
          qsum[r] = 0;
        }
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const float vs = col < p.d ? vsg[col] : 0.f;
            acc(j, e) = __fadd_rn(__fmul_rn(acc(j, e), alpha[e >> 1]),
                                  __fmul_rn(static_cast<float>(pv[j][e]), vs));
            pv[j][e] = 0;
          }
      }
    }
    stage ^= 1;
    cur = nxt;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= p.sq) continue;
    T* orow = og + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.d) break;
      orow[col] = from_float<T>(__fdiv_rn(acc(j, 2 * r), l[r]));
      if (col + 1 < p.d) orow[col + 1] = from_float<T>(__fdiv_rn(acc(j, 2 * r + 1), l[r]));
    }
  }
}

constexpr int bf16_smem(int block_k) { return (BQ * LD + KT * LD + BQ * (block_k + 1)) * 4; }

template <typename T>
int opt_in_imma() {
  static std::atomic<unsigned long long> opted{0};
  return opt_in_smem(int8_mma_kernel<T>, kI8Smem, opted);
}

template <typename T>
int launch_imma(const Params& p, dim3 grid, cudaStream_t stream) {
  if (int rc = opt_in_imma<T>()) return rc;
  int8_mma_kernel<T><<<grid, kMmaThreads, kI8Smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int imma_blocks_per_sm(int* blocks) {
  if (int rc = opt_in_imma<T>()) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, int8_mma_kernel<T>, kMmaThreads, kI8Smem));
}

template <typename T, bool kPrescaleQ>
int launch_fma(const Params& p, dim3 grid, cudaStream_t stream) {
  static std::atomic<unsigned long long> opted{0};
  auto kernel = bf16_variant_kernel<T, kPrescaleQ>;
  if (int rc = opt_in_smem(kernel, bf16_smem(kMaxBlockK), opted)) return rc;
  kernel<<<grid, kThreads, bf16_smem(p.block_k), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel's shared memory does not depend on block_k.
template <bool kPrescaleQ, bool kVec>
int opt_in_mma() {
  static std::atomic<unsigned long long> opted{0};
  return opt_in_smem(bf16_mma_kernel<kPrescaleQ, kVec>, kMmaSmem, opted);
}

template <bool kPrescaleQ, bool kVec>
int launch_mma(const Params& p, dim3 grid, cudaStream_t stream) {
  if (int rc = opt_in_mma<kPrescaleQ, kVec>()) return rc;
  bf16_mma_kernel<kPrescaleQ, kVec><<<grid, kMmaThreads, kMmaSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 = bf16, 1 = nomask, 2 = int8. dtype (of q/k/v for variants 0
// and 1, of the output for all): 0 = float32, 1 = float16, 2 = bfloat16.
// Variants 0 and 1 take the tensor-core kernel for bfloat16 (any block_k
// that is a multiple of 64; vec = 1 stages by cp.async and needs d % 8 == 0
// and 16-byte aligned rows, vec = 0 stages element by element) and the FMA
// kernel for float32 / float16 (block_k up to 512). Strides are in elements;
// the head dim must be contiguous. Variant 2 takes int8_mma_kernel on the
// operands as flash_variants.py::int8_kernel_operands lays them out, with
// vec = 1 and block_k up to 1024: q, k int8 [B, S, H, D16] (D16: d rounded
// up to 16, zero-padded), v the transposed int8 V^T [B, H, D16, Sk16] with
// (v_sb, v_ss, v_sh) its (batch, channel, head) strides, ks [B, H, Sk16]
// f32, qs [B, Sq, H] and vs [B, H, d] f32, all contiguous; every row starts
// on 16 bytes.
extern "C" int consolver_flash_variant_forward(
    int variant, int dtype, const void* q, const void* k, const void* v, const void* qs,
    const void* ks, const void* vs, void* o, int batch, int heads, int sq, int sk, int d,
    int block_k, int vec, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, void* stream) {
  if (variant < 0 || variant > 2 || d < 1 || d > DP || sq < 1 || sk < 1) return -1;
  if (dtype < 0 || dtype > 2) return -1;
  const bool mma = variant != 2 && dtype == 2;
  const int max_block_k = variant == 2 ? kMaxBlockKInt8 : mma ? block_k : kMaxBlockK;
  if (block_k < KT || block_k % KT != 0 || block_k > max_block_k) return -1;
  if (variant == 2) {
    if (!vec || qs == nullptr || ks == nullptr || vs == nullptr ||
        reinterpret_cast<unsigned long long>(ks) % 16 != 0 ||
        !rows_aligned(q, q_sb, q_ss, q_sh, 1) || !rows_aligned(k, k_sb, k_ss, k_sh, 1) ||
        !rows_aligned(v, v_sb, v_ss, v_sh, 1))
      return -1;
  } else if (vec && !(mma && d % 8 == 0 && rows_aligned(q, q_sb, q_ss, q_sh) &&
                      rows_aligned(k, k_sb, k_ss, k_sh) && rows_aligned(v, v_sb, v_ss, v_sh) &&
                      rows_aligned(o, o_sb, o_ss, o_sh))) {
    return -1;
  }
  Params p{{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh},
           q, k, v, static_cast<const float*>(qs), static_cast<const float*>(ks),
           static_cast<const float*>(vs), o, heads, sq, sk, d, block_k, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  if (variant == 2) {
    switch (dtype) {
      case 0: return launch_imma<float>(p, grid, s);
      case 1: return launch_imma<__half>(p, grid, s);
      default: return launch_imma<__nv_bfloat16>(p, grid, s);
    }
  }
  if (mma) {
    if (variant == 1)
      return vec ? launch_mma<true, true>(p, grid, s) : launch_mma<true, false>(p, grid, s);
    return vec ? launch_mma<false, true>(p, grid, s) : launch_mma<false, false>(p, grid, s);
  }
  if (dtype == 0)
    return variant == 1 ? launch_fma<float, true>(p, grid, s)
                        : launch_fma<float, false>(p, grid, s);
  return variant == 1 ? launch_fma<__half, true>(p, grid, s)
                      : launch_fma<__half, false>(p, grid, s);
}

// The tensor-core kernel of `variant` (0 or 1) with vec staging or not: its
// dynamic shared memory per block and how many blocks of it fit on one SM.
extern "C" int consolver_flash_mma_occupancy(int variant, int vec, int* smem_bytes,
                                             int* blocks_per_sm) {
  int rc = 0;
  *smem_bytes = kMmaSmem;
  if (variant == 1) {
    rc = vec ? opt_in_mma<true, true>() : opt_in_mma<true, false>();
    if (rc) return rc;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, vec ? bf16_mma_kernel<true, true> : bf16_mma_kernel<true, false>,
        kMmaThreads, kMmaSmem));
  }
  rc = vec ? opt_in_mma<false, true>() : opt_in_mma<false, false>();
  if (rc) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, vec ? bf16_mma_kernel<false, true> : bf16_mma_kernel<false, false>,
      kMmaThreads, kMmaSmem));
}

// int8_mma_kernel for output type dtype (0 = float32, 1 = float16, 2 =
// bfloat16): its dynamic shared memory per block and how many blocks of it
// fit on one SM.
extern "C" int consolver_flash_imma_occupancy(int dtype, int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = kI8Smem;
  switch (dtype) {
    case 0: return imma_blocks_per_sm<float>(blocks_per_sm);
    case 1: return imma_blocks_per_sm<__half>(blocks_per_sm);
    case 2: return imma_blocks_per_sm<__nv_bfloat16>(blocks_per_sm);
    default: return -1;
  }
}
