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
// width in shared memory only.
//
// What bounds it: the work is 4*B*H*Sq*Sk*d operations against
// (|q| + |k| + |v| + |o|) bytes. The self-attentions that carry the time
// (the SD-1.5 UNet at S = 4096 and 1024, both VAEs' single-head d = 512, the
// FLUX joint attention over 8704 tokens) do 500 to 2,200 operations per
// byte, above the card's ~295, so the kernel is compute-bound there; only
// the 77-key cross-attentions and the S <= 256 levels sit below the line
// (PERF.md has each shape's bound, from chip_smoke.py).
//
// The function is the Pallas kernel's: scores and probabilities p in f32.
// Two routes, chosen by the type of q/k/v:
//
// * "mma", bf16 q/k/v: tensor cores (wgmma in design H; mma.sync m16n8k16
//   bf16 x bf16 -> f32, fragments by ldmatrix, .trans for V, in designs A
//   and B). q.k^T of bf16 values is exact in
//   its products and sums in f32, so it costs nothing against f32 math; the
//   scores are then scaled by (1/sqrt(d)) log2(e) in f32 and go through
//   exp2f, as on the FMA route. A bf16 p would not keep the function (about
//   10x the one-ulp limit at SD and FLUX shapes), so p is split into
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi) and acc += p_hi v + p_lo v: two
//   MMAs per V fragment, which is loaded once for both (1.5x the function's
//   MMA work; p_hi + p_lo carries 16 bits of p, and the output matches f32
//   p to its own rounding). l sums the f32 p. One online-softmax pass per
//   K/V tile: keys >= Sk are set to -1e30 before the max (zero-filled K rows
//   would score 0), and V rows past Sk are zeros (0 x NaN is NaN). The
//   padded head dim is a template parameter, so the MMA loops have no
//   branch on d. When rows are 16-byte aligned and d % 8 == 0, tiles arrive
//   by copies: TMA in design H, cp.async 16-byte copies into a 2-stage K/V
//   ring (one barrier per tile) in A and B; else element by element
//   (kVec = false, A and B only). Three designs:
//   - H, with copies, on kernels 64 and 128 columns wide: padded widths 64
//     and 128 (the SD3.5 joint attention at d = 64, FLUX's at d = 128, the
//     d = 64 backbones) and, where measured faster than A at every
//     main-path shape, SD-1.5's width 80 (on the 128 kernel) and width 48
//     with more than one key tile (its self-attention, on the 64 kernel);
//     flash_fwd_wgmma_kernel: Hopper's own tensor-core path. mma.sync
//     reaches under a third of the card's 989 TFLOP/s; wgmma, fed by TMA
//     and overlapped by warp specialisation, is the way to the full rate.
//     What bounds it: at d = 128 the MMAs (1.5x the function's work); at
//     d = 64 the exponentials cost about as much as the MMAs (one exp2 a
//     score on the SFU, 16 a clock per SM, against 64 x 2 x 1.5 MMA
//     operations a score), so one consumer warpgroup's softmax runs while
//     the other's MMAs do (below). 128 query rows, 128-key tiles, 1 block
//     per SM; the notes at the kernel give the layout.
//   - A, the other widths up to 160 (SD's 160, its 48-wide cross-attention
//     over 77 keys) and every unaligned call up to 160,
//     flash_fwd_mma_a_kernel: 4
//     warps x 16 query rows, 64-key tiles, the head dim padded to a multiple
//     of 16 (40 -> 48). Q passes once through the ring into A fragments held
//     in registers; the f32 accumulator of a warp's 16 rows x all columns
//     stays in registers (d = 160: 80 a thread), and p goes from the score
//     C fragments into the A fragments of the p.v MMAs in registers. 2 to 4
//     blocks per SM by width.
//   - B, 160 < d <= 512 (both VAEs' mid attention, d = 512),
//     flash_fwd_mma_b_kernel: 16 x 512 f32 would be 256 registers a thread,
//     so 8 warps split the output columns in two halves. Q (64 x 512 bf16)
//     stays in shared memory and is read by ldmatrix at every k-step; for
//     each 32-key tile, warp (slab, half) scores its slab's 16 rows against
//     the half's 16 keys, the row max crosses the two halves through shared
//     memory, p_hi and p_lo go to shared memory as bf16, and each warp
//     accumulates its slab's rows over its half of the output columns
//     (d = 512: 128 f32 a thread). 206 KB of shared memory, 1 block per SM.
//
// * "fma", f32 / f16 q/k/v, flash_fwd_kernel (a bf16 MMA would round them):
//   plain f32 FMAs from shared memory. Each thread keeps a register
//   micro-tile of RQ rows x CK scores and RQ rows x DP/16 output columns,
//   the S tile never leaves the SM, and row strides of DP + 1 floats keep
//   the column reads free of bank conflicts; head dims zero-filled to
//   32, 48, 64, 80, 128, 160, 256 or 512.
//
// C interface (route: nvcc -> shared library -> ctypes):
//   consolver_flash_attention_forward(...) returns cudaGetLastError() after
//   the launch (0 = success), -2 / -3 when design H's tensor maps cannot be
//   made (cuTensorMapEncodeTiled not found / it refuses the operand's layout),
//   or -1 for a head dim / dtype / staging / design it does not take; the
//   wrapper picks the tensor-core design (flash_attention.py::mma_design).
//   consolver_flash_attention_mma_info(...) reports the kernel a design
//   runs at a head dim: its width, threads, dynamic shared memory and
//   resident blocks per SM.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

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

// ---------------------------------------------------------------------------
// Tensor-core route ("mma"): bf16 q/k/v.
// ---------------------------------------------------------------------------

constexpr int kMaxWidthA = 160;  // design A up to this head dim, design B above

// p_hi = bf16(p), p_lo = bf16(p - p_hi) of two neighbouring columns, packed
// as one 32-bit A-fragment register each (the lower column in the low half).
// p - p_hi is exact in f32.
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// Lane offsets (row, column) of the ldmatrix.x4 addresses. a_*: A fragments
// (16 rows x 16 columns), and with .trans the B fragments of two 8-column
// n-tiles from 16 V rows, which take the same pattern. k_*: B fragments of
// two 8-key n-tiles from K rows.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int k_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int k_col(int lane) { return ((lane >> 3) & 1) << 3; }

// Design A: 4 warps x 16 query rows, 64-key tiles.
constexpr int kThreadsA = 128;
constexpr int kRowsA = 64;
constexpr int kKeysA = 64;
static_assert(kRowsA == kKeysA && kRowsA == 16 * (kThreadsA / 32), "one 16-row slab per warp");

constexpr int smem_a(int dp) { return 4 * kKeysA * (dp + 8) * 2; }  // 2 stages x (K, V)
// Blocks per SM the registers are held to: narrow heads have the fewest
// MMAs per exponential and need the most warps to hide latency.
constexpr int min_blocks_a(int dp) { return dp <= 48 ? 4 : dp <= 128 ? 3 : 2; }

template <int DP, bool kVec>
__global__ void __launch_bounds__(kThreadsA, min_blocks_a(DP)) flash_fwd_mma_a_kernel(Params p) {
  static_assert(DP % 16 == 0 && DP <= kMaxWidthA, "design A widths");
  constexpr int LDS = DP + 8;
  constexpr int TILE = kKeysA * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at tile 2s, V at 2s + 1
  // Q passes through stage 1's K slot: it is read into registers before the
  // loop's first barrier, after which the ring overwrites it.
  bf16* qtile = ring + 2 * TILE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kRowsA;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  auto issue = [&](int stage, int k0) {
    bf16* kt = ring + 2 * stage * TILE;
    stage_rows<kKeysA, DP, kThreadsA, kVec>(kt, kg, p.k_ss, k0, p.sk, p.d);
    stage_rows<kKeysA, DP, kThreadsA, kVec>(kt + TILE, vg, p.v_ss, k0, p.sk, p.d);
  };

  stage_rows<kRowsA, DP, kThreadsA, kVec>(qtile, qg, p.q_ss, q0, p.sq, p.d);
  issue(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[DP / 16][4];  // the warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4(qf[kk], qtile + (16 * warp + a_row(lane)) * LDS + 16 * kk + a_col(lane));

  // Per thread two rows: g = lane / 4 (index 0) and g + 8 (index 1) of the
  // warp's slab; acc[j] holds output columns 8j..8j+7. l sums this thread's
  // columns only; the quad's four partial sums are added at the end.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int tcol = 2 * (lane & 3);

  int stage = 0;
  for (int k0 = 0; k0 < p.sk; k0 += kKeysA) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has arrived; every warp is done with the other stage
    if (k0 + kKeysA < p.sk) issue(stage ^ 1, k0 + kKeysA);  // in flight during this tile
    cp_async_commit();
    const bf16* kt = ring + 2 * stage * TILE;
    const bf16* vt = kt + TILE;

    float s[8][4];  // the warp's 16 x 64 scores, s[j] = keys 8j..8j+7 (C layout)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {  // keys 16jp..16jp+15: two 8-key n-tiles
        unsigned bk[4];
        ldmatrix_x4(bk, kt + (16 * jp + k_row(lane)) * LDS + 16 * kk + k_col(lane));
        mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (k0 + 8 * j + tcol + (e & 1) >= p.sk) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the row's max over the quad's columns
      float x = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += pr;
        s[j][e] = pr;
      }

    // acc += p_hi v + p_lo v. The C fragments of keys 16kk..16kk+15 are the
    // A fragment of that k-step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned phi[4], plo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], phi[0], plo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], phi[1], plo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], phi[2], plo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], phi[3], plo[3]);
#pragma unroll
      for (int jp = 0; jp < DP / 16; ++jp) {  // output columns 16jp..16jp+15
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + (16 * kk + a_row(lane)) * LDS + 16 * jp + a_col(lane));
        mma_bf16(acc[2 * jp], phi, bv[0], bv[1]);
        mma_bf16(acc[2 * jp + 1], phi, bv[2], bv[3]);
        mma_bf16(acc[2 * jp], plo, bv[0], bv[1]);
        mma_bf16(acc[2 * jp + 1], plo, bv[2], bv[3]);
      }
    }
    stage ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
    if (row >= p.sq) continue;
    const float inv = 1.f / l[r];
    bf16* orow = og + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + tcol;
      if (col >= p.d) break;
      const float lo = acc[j][2 * r] * inv;
      const float hi = acc[j][2 * r + 1] * inv;
      if (kVec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(lo, hi);
      } else {
        orow[col] = __float2bfloat16_rn(lo);
        if (col + 1 < p.d) orow[col + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// Design B: 8 warps, 64 query rows, 32-key tiles. Warp w owns slab
// w % 4 (16 rows) and half w / 4: keys 16 half.. of each tile for the
// scores, output columns half * DP / 2.. for the accumulator.
constexpr int kThreadsB = 256;
constexpr int kRowsB = 64;
constexpr int kKeysB = 32;
constexpr int kLdp = kKeysB + 8;  // bf16 row stride of the p tiles
static_assert(kRowsB == 16 * (kThreadsB / 32) / 2 && kKeysB == 2 * 16, "4 slabs x 2 halves");

// Q, 2 stages x (K, V), p_hi and p_lo, and 2 x 64 floats for the row max
// and sum of each half.
constexpr int smem_b(int dp) {
  return ((kRowsB + 4 * kKeysB) * (dp + 8) + 2 * kRowsB * kLdp) * 2 + 2 * kRowsB * 4;
}

template <int DP, bool kVec>
__global__ void __launch_bounds__(kThreadsB, 1) flash_fwd_mma_b_kernel(Params p) {
  static_assert(DP % 32 == 0 && DP > kMaxWidthA, "design B widths");
  constexpr int LDS = DP + 8;
  constexpr int KTILE = kKeysB * LDS;
  constexpr int HALF = DP / 2;  // output columns per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LDS], resident
  bf16* ring = qs + kRowsB * LDS;                // stage s: K at 2s, V at 2s + 1
  bf16* phi = ring + 4 * KTILE;                  // [64][kLdp] bf16(p)
  bf16* plo = phi + kRowsB * kLdp;               // [64][kLdp] bf16(p - bf16(p))
  float* red = reinterpret_cast<float*>(plo + kRowsB * kLdp);  // [2][64] per half

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = warp & 3;
  const int half = warp >> 2;
  const int q0 = blockIdx.x * kRowsB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  auto issue = [&](int stage, int k0) {
    bf16* kt = ring + 2 * stage * KTILE;
    stage_rows<kKeysB, DP, kThreadsB, kVec>(kt, kg, p.k_ss, k0, p.sk, p.d);
    stage_rows<kKeysB, DP, kThreadsB, kVec>(kt + KTILE, vg, p.v_ss, k0, p.sk, p.d);
  };
  stage_rows<kRowsB, DP, kThreadsB, kVec>(qs, qg, p.q_ss, q0, p.sq, p.d);
  issue(0, 0);
  cp_async_commit();

  const int g = lane >> 2;
  const int tcol = 2 * (lane & 3);
  const int arow = 16 * slab + a_row(lane);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HALF / 8][4];
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  for (int k0 = 0; k0 < p.sk; k0 += kKeysB) {
    cp_async_wait<0>();
    // This tile (and Q) has arrived; every warp is done with the other
    // stage, the p tiles and the row maxima of the previous tile.
    __syncthreads();
    if (k0 + kKeysB < p.sk) issue(stage ^ 1, k0 + kKeysB);
    cp_async_commit();
    const bf16* kt = ring + 2 * stage * KTILE;
    const bf16* vt = kt + KTILE;

    // 1. the slab's 16 rows x the half's 16 keys; even and odd k-steps sum
    // into separate accumulators, so that two MMA chains are in flight.
    float s[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[c][j][0] = s[c][j][1] = s[c][j][2] = s[c][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      unsigned a[4], bk[4];
      ldmatrix_x4(a, qs + arow * LDS + 16 * kk + a_col(lane));
      ldmatrix_x4(bk, kt + (16 * half + k_row(lane)) * LDS + 16 * kk + k_col(lane));
      mma_bf16(s[kk & 1][0], a, bk[0], bk[1]);
      mma_bf16(s[kk & 1][1], a, bk[2], bk[3]);
    }
    float x[2][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = (s[0][j][e] + s[1][j][e]) * p.scale_log2;
        if (k0 + 16 * half + 8 * j + tcol + (e & 1) >= p.sk) v = kNegInf;
        x[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if ((lane & 3) == 0) red[half * kRowsB + 16 * slab + g + 8 * r] = mx[r];
    }
    __syncthreads();  // both halves' row maxima

    // 2. the tile's row max over both halves (the two warps of a slab
    // compute the same m and alpha); p of the half's keys: l sums the f32 p,
    // p_hi and p_lo go to shared memory.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * slab + g + 8 * r;
      const float m_new = fmaxf(m[r], fmaxf(red[row], red[kRowsB + row]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p0 = exp2f(x[j][2 * r] - m_new);
        const float p1 = exp2f(x[j][2 * r + 1] - m_new);
        l[r] += p0 + p1;
        unsigned hi, lo;
        split_bf16(p0, p1, hi, lo);
        const int off = row * kLdp + 16 * half + 8 * j + tcol;
        *reinterpret_cast<unsigned*>(phi + off) = hi;
        *reinterpret_cast<unsigned*>(plo + off) = lo;
      }
    }
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    __syncthreads();  // the p tiles are whole

    // 3. acc (the slab's rows x the half's columns) += p_hi v + p_lo v
#pragma unroll
    for (int ks = 0; ks < kKeysB / 16; ++ks) {
      unsigned ah[4], al[4];
      ldmatrix_x4(ah, phi + arow * kLdp + 16 * ks + a_col(lane));
      ldmatrix_x4(al, plo + arow * kLdp + 16 * ks + a_col(lane));
#pragma unroll
      for (int jp = 0; jp < HALF / 16; ++jp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + (16 * ks + a_row(lane)) * LDS + HALF * half + 16 * jp +
                                  a_col(lane));
        mma_bf16(acc[2 * jp], ah, bv[0], bv[1]);
        mma_bf16(acc[2 * jp + 1], ah, bv[2], bv[3]);
        mma_bf16(acc[2 * jp], al, bv[0], bv[1]);
        mma_bf16(acc[2 * jp + 1], al, bv[2], bv[3]);
      }
    }
    stage ^= 1;
  }

  // l over the quad, then over the two halves (every warp has read the last
  // row maxima before the last tile's second barrier).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if ((lane & 3) == 0) red[half * kRowsB + 16 * slab + g + 8 * r] = l[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int srow = 16 * slab + g + 8 * r;
    const int row = q0 + srow;
    if (row >= p.sq) continue;
    const float inv = 1.f / (red[srow] + red[kRowsB + srow]);
    bf16* orow = og + row * p.o_ss + HALF * half;
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int col = 8 * j + tcol;
      if (HALF * half + col >= p.d) break;
      const float lo = acc[j][2 * r] * inv;
      const float hi = acc[j][2 * r + 1] * inv;
      if (kVec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(lo, hi);
      } else {
        orow[col] = __float2bfloat16_rn(lo);
        if (HALF * half + col + 1 < p.d) orow[col + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// Design H (sm_90a), flash_fwd_wgmma_kernel<64 | 128>: head dims up to 64
// and up to 128 with aligned rows (the wrapper's mma_design says which).
// 3 warpgroups, 128 query rows a block: warpgroup 2 is the producer, whose
// one thread keeps TMA loads of Q (once) and of the K and V tiles (a ring of
// kStagesH stages, one full and one empty mbarrier per tile and stage) in
// flight; warpgroups 0 and 1 each own 64 query rows. A consumer's tile j:
// S_j = Q K_j^T by wgmma m64n128k16 from shared memory, then the output's
// rescale by the previous tile's alpha and O += p_hi V_{j-1} + p_lo V_{j-1}
// by wgmma m64nDPk16 with p in registers (the S accumulator repacked into
// A fragments) and V read MN-major; the online softmax of S_j runs while
// that p.v product is in flight. The two consumers take turns to issue
// their products (named barriers 1 and 2), so one warpgroup's exponentials
// overlap the other's MMAs. setmaxnreg gives the consumers 240 registers a
// thread (S 64, O 32 / 64, p_hi and p_lo 64) and the producer 24. TMA's
// zero fill covers the rows past Sq and Sk (4429 = 34 x 128 + 77) and the
// columns past d; keys past Sk are masked before the max, as in A.

// 2^x on the SFU with subnormal results flushed to 0: a p below 2^-126
// adds nothing to an l of at least 1, and exp2f's subnormal handling costs
// three more instructions a score.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kThreadsH = 384;
constexpr int kRowsH = 128;  // 64 per consumer warpgroup
constexpr int kKeysH = 128;
constexpr int kStagesH = 2;
constexpr int kConsumerRegsH = 240;
constexpr int kProducerRegsH = 24;

// Q, kStagesH x (K, V), 1 + 4 kStagesH mbarriers, and 1 KB to align the
// tiles to the swizzle's 1024-byte atoms.
constexpr int smem_h(int dp) {
  return (kRowsH + 2 * kStagesH * kKeysH) * dp * 2 + 8 * (1 + 4 * kStagesH) + 1024;
}

template <int DP>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  static_assert(DP == 64 || DP == 128, "design H widths");
  constexpr int CB = DP / 64;                  // 64-column blocks of a tile (128-byte rows)
  constexpr unsigned QBYTES = kRowsH * DP * 2;
  constexpr unsigned TBYTES = kKeysH * DP * 2;  // one K or V tile
  constexpr int NT = kKeysH / 8;                // 8-key n-tiles of S
  static_assert(kRowsH == kKeysH, "Q and K tiles share their column-block offsets");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned qs = (smem_addr(smem_raw) + 1023) & ~1023u;  // [CB][128 rows][64]
  const unsigned ks = qs + QBYTES;                            // stage s: [CB][128 keys][64]
  const unsigned vs = ks + kStagesH * TBYTES;
  const unsigned bars = vs + kStagesH * TBYTES;
  const unsigned qfull = bars;
  auto kfull = [&](int s) { return bars + 8 * (1 + s); };
  auto vfull = [&](int s) { return bars + 8 * (1 + kStagesH + s); };
  auto kempty = [&](int s) { return bars + 8 * (1 + 2 * kStagesH + s); };
  auto vempty = [&](int s) { return bars + 8 * (1 + 3 * kStagesH + s); };

  const int q0 = blockIdx.x * kRowsH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = (p.sk + kKeysH - 1) / kKeysH;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStagesH; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(kempty(s), 8);  // lane 0 of each consumer warp
      mbar_init(vempty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<kProducerRegsH>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qfull, QBYTES);
      for (int c = 0; c < CB; ++c) tma_load_4d(qs + c * kRowsH * 128, &tq, qfull, 64 * c, h, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStagesH;
        const unsigned free_parity = ((j / kStagesH) & 1) ^ 1;
        mbar_wait(kempty(s), free_parity);
        mbar_expect_tx(kfull(s), TBYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(ks + s * TBYTES + c * kKeysH * 128, &tk, kfull(s), 64 * c, h, j * kKeysH, b);
        mbar_wait(vempty(s), free_parity);
        mbar_expect_tx(vfull(s), TBYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(vs + s * TBYTES + c * kKeysH * 128, &tv, vfull(s), 64 * c, h, j * kKeysH, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegsH>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
    const int tcol = 2 * (lane & 3);
    const unsigned qwg = qs + wg * 64 * 128;   // this warpgroup's 64 rows in each column block
    const int turn = 1 + wg, next = 2 - wg;    // named barriers: whose turn to issue MMAs

    float s[NT * 4];     // S of the tile, then its f32 p
    float o[DP / 2];     // O, m64nDP
    unsigned phi[kKeysH / 16][4], plo[kKeysH / 16][4];  // bf16(p), bf16(p - bf16(p)): A fragments
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

    auto issue_scores = [&](int stage) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const unsigned off = (kk / 4) * 128 * 128 + (kk % 4) * 32;  // 128 rows in both tiles
        wgmma_ss_m64n128(s, sw128_desc(qwg + off, 16, 1024),
                         sw128_desc(ks + stage * TBYTES + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int stage) {
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeysH / 16; ++kk) {  // keys 16kk..16kk+15: 2 x 8 rows of 128 bytes
        const unsigned long long dv =
            sw128_desc(vs + stage * TBYTES + kk * 2048, kKeysH * 128, 1024);
        if constexpr (DP == 64) {
          wgmma_rs_m64n64(o, phi[kk], dv);
          wgmma_rs_m64n64(o, plo[kk], dv);
        } else {
          wgmma_rs_m64n128(o, phi[kk], dv);
          wgmma_rs_m64n128(o, plo[kk], dv);
        }
      }
      wgmma_commit();
    };
    // Online softmax of the tile at key k0: raw scores -> f32 p in s; sets
    // alpha, m and l (this thread's columns; the quad adds up at the end).
    auto softmax = [&](int k0) {
      if (k0 + kKeysH > p.sk) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + tcol + (e & 1) >= p.sk) s[4 * j + e] = kNegInf;
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[r], x * p.scale_log2);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = ex2_ftz(fmaf(s[4 * j + e], p.scale_log2, -m[e >> 1]));
          l[e >> 1] += pr;
          s[4 * j + e] = pr;
        }
    };
    // The C fragments of keys 16kk..16kk+15 are the A fragment of k-step kk.
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kKeysH / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], phi[kk][i], plo[kk][i]);
    };

    if (wg == 1) named_arrive(1, 256);  // warpgroup 0 issues first
    mbar_wait(qfull, 0);

    mbar_wait(kfull(0), 0);
    named_sync(turn, 256);
    issue_scores(0);
    if (wg == 0 || ntiles > 1) named_arrive(next, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(kempty(0));
    softmax(0);
    split_p();
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kStagesH, prev = (j - 1) % kStagesH;
      mbar_wait(kfull(st), (j / kStagesH) & 1);
      named_sync(turn, 256);
      issue_scores(st);
      mbar_wait(vfull(prev), ((j - 1) / kStagesH) & 1);
      issue_pv(prev);
      if (wg == 0 || j < ntiles - 1) named_arrive(next, 256);
      wgmma_wait<1>();  // S_j; the p.v product of tile j - 1 is still in flight
      fence_regs(s);
      if (lane == 0) mbar_arrive(kempty(st));
      softmax(j * kKeysH);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(vempty(prev));
      split_p();
    }
    const int last = (ntiles - 1) % kStagesH;
    mbar_wait(vfull(last), ((ntiles - 1) / kStagesH) & 1);
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
      if (row >= p.sq) continue;
      const float inv = 1.f / l[r];
      bf16* orow = og + row * p.o_ss;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + tcol;
        if (col >= p.d) break;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link flag:
// the library links only the runtime).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one [B, S, H, D] bf16 operand for tiles of `rows` rows x
// 64 columns in the 128-byte swizzle; rows past S and columns past d read as
// zeros. 0 on success.
int bshd_tensor_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int d,
                    long long sb, long long ss, long long sh, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : -3;
}

template <int DP>
int launch_wgmma(const Params& p, int batch, int heads, int smem, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int rc = bshd_tensor_map(&tq, p.q, batch, p.sq, heads, p.d, p.q_sb, p.q_ss, p.q_sh, kRowsH))
    return rc;
  if (int rc = bshd_tensor_map(&tk, p.k, batch, p.sk, heads, p.d, p.k_sb, p.k_ss, p.k_sh, kKeysH))
    return rc;
  if (int rc = bshd_tensor_map(&tv, p.v, batch, p.sk, heads, p.d, p.v_sb, p.v_ss, p.v_sh, kKeysH))
    return rc;
  const dim3 grid((p.sq + kRowsH - 1) / kRowsH, heads, batch);
  flash_fwd_wgmma_kernel<DP><<<grid, kThreadsH, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel of one padded width and staging, with its launch
// shape and its once-per-device shared-memory opt-in.
struct MmaKernel {
  const void* fn;
  int design;  // 0 = A, 1 = B, 2 = H
  int width, threads, rows, smem;
  std::atomic<unsigned long long>* opted;
};

template <int DP, bool kVec>
MmaKernel mma_kernel_of() {
  static std::atomic<unsigned long long> opted{0};
  if constexpr (DP <= kMaxWidthA)
    return {reinterpret_cast<const void*>(flash_fwd_mma_a_kernel<DP, kVec>), 0, DP, kThreadsA,
            kRowsA, smem_a(DP), &opted};
  else
    return {reinterpret_cast<const void*>(flash_fwd_mma_b_kernel<DP, kVec>), 1, DP, kThreadsB,
            kRowsB, smem_b(DP), &opted};
}

template <int DP>
MmaKernel wgmma_kernel_of() {
  static std::atomic<unsigned long long> opted{0};
  return {reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<DP>), 2, DP, kThreadsH, kRowsH,
          smem_h(DP), &opted};
}

// d in 1..512: designs A and B pad to a multiple of 16 up to 160, then 256
// or 512.
template <bool kVec>
MmaKernel mma_kernel(int d) {
  switch ((d + 15) / 16) {
    case 1: return mma_kernel_of<16, kVec>();
    case 2: return mma_kernel_of<32, kVec>();
    case 3: return mma_kernel_of<48, kVec>();
    case 4: return mma_kernel_of<64, kVec>();
    case 5: return mma_kernel_of<80, kVec>();
    case 6: return mma_kernel_of<96, kVec>();
    case 7: return mma_kernel_of<112, kVec>();
    case 8: return mma_kernel_of<128, kVec>();
    case 9: return mma_kernel_of<144, kVec>();
    case 10: return mma_kernel_of<160, kVec>();
    default: return d <= 256 ? mma_kernel_of<256, kVec>() : mma_kernel_of<512, kVec>();
  }
}

// The kernel of `design` (0 = A, 1 = B, 2 = H; the wrapper's mma_design
// picks it) at head dim d and staging vec; fn is null where the design does
// not take them: A up to d = 160, B above, H up to 128 with copies (the
// head dim padded to 64 or 128). A stays built at the widths H takes: it is
// chip_smoke.py's yardstick for the wrapper's rule.
MmaKernel mma_kernel(int design, int d, bool vec) {
  if (design == 2) {
    if (!vec || d > 128) return {};
    return d <= 64 ? wgmma_kernel_of<64>() : wgmma_kernel_of<128>();
  }
  if (design != (d <= kMaxWidthA ? 0 : 1)) return {};
  return vec ? mma_kernel<true>(d) : mma_kernel<false>(d);
}

int launch_mma(const Params& p, int design, bool vec, int batch, int heads, cudaStream_t stream) {
  const MmaKernel k = mma_kernel(design, p.d, vec);
  if (k.fn == nullptr) return -1;
  if (int rc = opt_in_smem(k.fn, k.smem, *k.opted)) return rc;
  if (k.design == 2)
    return k.width == 64 ? launch_wgmma<64>(p, batch, heads, k.smem, stream)
                         : launch_wgmma<128>(p, batch, heads, k.smem, stream);
  const dim3 grid((p.sq + k.rows - 1) / k.rows, heads, batch);
  Params args = p;
  void* argv[] = {&args};
  const cudaError_t err = cudaLaunchKernel(k.fn, grid, dim3(k.threads), argv, k.smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float16 (both on the FMA kernel), 2 = bfloat16
// (the tensor-core kernels, of `design`: 0 = A, 1 = B, 2 = H; ignored on
// the FMA kernel). vec = 1 stages bf16 tiles by copies (cp.async, or TMA
// in design H) and needs d % 8 == 0 and 16-byte aligned rows; vec = 0
// stages element by element (designs A and B, and the FMA kernel). Strides
// are in elements; the head dim must be contiguous (stride 1).
extern "C" int consolver_flash_attention_forward(
    int dtype, const void* q, const void* k, const void* v, void* o, int batch, int heads,
    int sq, int sk, int d, int vec, int design, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, float scale, void* stream) {
  if (d < 1 || d > 512 || sk < 1 || sq < 1) return -1;
  if (vec && !(dtype == 2 && d % 8 == 0 && rows_aligned(q, q_sb, q_ss, q_sh) &&
               rows_aligned(k, k_sb, k_ss, k_sh) && rows_aligned(v, v_sb, v_ss, v_sh) &&
               rows_aligned(o, o_sb, o_ss, o_sh)))
    return -1;
  Params p{{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh},
           q, k, v, o, sq, sk, d, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_for_dim<float>(p, batch, heads, s);
    case 1: return launch_for_dim<__half>(p, batch, heads, s);
    case 2: return launch_mma(p, design, vec != 0, batch, heads, s);
    default: return -1;
  }
}

// The tensor-core kernel a bf16 call of `design` (0 = A, 1 = B, 2 = H) with
// head dim d (1..512) and staging vec launches: its padded width, threads
// per block, dynamic shared memory per block and resident blocks per SM;
// -1 where the design does not take d and vec.
extern "C" int consolver_flash_attention_mma_info(int design, int d, int vec, int* width,
                                                  int* threads, int* smem_bytes,
                                                  int* blocks_per_sm) {
  if (d < 1 || d > 512) return -1;
  const MmaKernel k = mma_kernel(design, d, vec != 0);
  if (k.fn == nullptr) return -1;
  if (int rc = opt_in_smem(k.fn, k.smem, *k.opted)) return rc;
  *width = k.width;
  *threads = k.threads;
  *smem_bytes = k.smem;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k.fn, k.threads, k.smem));
}
