// The multi-head attention forward body shared by attention_lse_fwd.cu
// (the stored-statistics variant, kStats) and attention_fwd.cu (the
// recompute variant, kPlain, and its bf16-exponential branch, kBf16Exp).
// For each (batch b, head h):
//   logits = (q * (scale * log2e)) . k^T   q scaled in q's dtype, fp32 sums
//   m      = rowmax(logits)                log2 domain, exact
//   e      = exp2(logits - m);  s = sum(e) over the fp32 e's
//   o      = (e cast to v's dtype) . v, fp32 sums, then / s, in q's dtype
// kStats also writes m and s (fp32 [B, Lq, H]) for the backward kernel.
// kBf16Exp (bf16 only) takes e = bf16(exp2(bf16(logits - m))) and sums
// those bf16 e's, as the TPU kernel's ones-column appended to v sums them.
// q, k and v are read through their batch and row strides, so the column
// slices of the packed qkv projection [B, L, 3*H*D] are read in place; o
// is written contiguous [B, Lq, H, D].  No online rescaling: m is the
// exact max of the logits that are exponentiated, as in the TPU kernels.
//
// What bounds it on an H100: bytes.  At the predict shapes (B = 512, L =
// 256, H = 6, D = 64, bf16) the function moves 409 MB (q, k, v read, o
// written, m and s written), 0.122 ms at 3.35 TB/s, against 77 GFLOP on
// the bf16 tensor cores with this design's second q . k^T (0.078 ms).
//
// bf16: attn_fwd_mma_kernel.  One warpgroup (4 warps) takes 64 query rows
// of one (b, h), 16 rows a warp, against all keys, in two sweeps over K:
//  * products on the tensor cores: mma.sync m16n8k16 with bf16 operands
//    from ldmatrix (K as stored for q . k^T, V through ldmatrix.trans for
//    e . v) and fp32 accumulators, not FMAs from shared memory;
//  * operands stay bf16 and move by 16-byte cp.async: the Q tile once,
//    scaled in registers and kept as A fragments; K and V in 64-key tiles
//    through a ring of kMmaStages stages, so copies overlap the products.
//    Rows are padded by 16 bytes, so ldmatrix has no bank conflicts;
//  * no score tile: sweep 1 keeps only each row's max; sweep 2 computes
//    the same logits again with the same instruction sequence (the same
//    bits, so m is exactly their max), forms e, adds it to s, and packs e
//    as bf16 straight into the A fragments of e . v.  Shared memory does
//    not grow with Lk (45 KB at D = 64), so four blocks share an SM;
//  * a 1-D grid, query block fastest: the query blocks of one (b, h) run
//    side by side, so K and V come from device memory once and then from
//    L2, where a grid with (b, h) fastest read them about four times.
// The design pays one extra q . k^T (77 instead of 51.5 GFLOP at B = 512)
// for no Lk-dependent shared memory and an exact softmax by construction.
//
// fp32: attn_fwd_fma_kernel, the port's parity path (a tensor-core fp32
// product runs in TF32, about three digits).  One CTA of 256 threads owns
// 64 query rows against all keys; the 64 x Lk fp32 score tile stays in
// shared memory, so the softmax is exact in one pass; the products are
// fp32 FMAs from shared memory, summed in ascending D, and the row max and
// sum taken in one fixed order, as the backward kernels take them
// (attention_bwd.cuh).  Its shared memory sets the Lk limit the wrapper
// checks (fwd_smem_bytes).
#pragma once

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

enum class FwdMode { kStats, kPlain, kBf16Exp };

// ---- fp32: the FMA body ------------------------------------------------

constexpr int kFwdThreads = 256;
constexpr int kFwdBQ = 64;  // query rows per CTA (both bodies)
constexpr int kFwdKC = 64;  // keys per staged chunk (both bodies)

size_t fwd_smem_bytes(int head_dim, int lk) {
  return sizeof(float) * (static_cast<size_t>(kFwdBQ) * (head_dim + 1) +
                          static_cast<size_t>(head_dim) * (kFwdKC + 1) +
                          static_cast<size_t>(kFwdBQ) * (lk + 1) + kFwdBQ);
}

template <int D, FwdMode M>
__global__ void __launch_bounds__(kFwdThreads)
attn_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ s_out,
                    int Lq, int Lk, int H, int n_qb,
                    long long qbs, long long qrs, long long kbs, long long krs,
                    long long vbs, long long vrs, float qscale) {
  constexpr int kThreads = kFwdThreads, kBQ = kFwdBQ, kKC = kFwdKC;
  extern __shared__ float fma_smem[];
  const int ld_s = Lk + 1;
  float* q_s = fma_smem;                // [kBQ][D + 1] scaled q
  float* kv_s = q_s + kBQ * (D + 1);    // K^T chunk [D][kKC + 1] or V chunk [kKC][D]
  float* sc_s = kv_s + D * (kKC + 1);   // scores, then e [kBQ][Lk + 1]
  float* sum_s = sc_s + kBQ * ld_s;     // row sums [kBQ]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (blockIdx.x % n_qb) * kBQ;
  const float* qb = q + b * qbs + h * D;
  const float* kb = k + b * kbs + h * D;
  const float* vb = v + b * vbs + h * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    q_s[r * (D + 1) + d] = (q0 + r < Lq) ? qb[(q0 + r) * qrs + d] * qscale : 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;

  // logits, one 64-key chunk at a time
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[d * (kKC + 1) + j] = (k0 + j < Lk) ? kb[(k0 + j) * krs + d] : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[d * (kKC + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col < Lk) sc_s[(ty * 4 + i) * ld_s + col] = acc[i][j];
      }
  }
  __syncthreads();

  // exact softmax statistics over the whole row: one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float* row = sc_s + r * ld_s;
    float mx = -INFINITY;
    for (int c = lane; c < Lk; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < Lk; c += 32) {
      const float e = exp2f(row[c] - mx);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sum_s[r] = sum;
      if constexpr (M == FwdMode::kStats) {
        if (q0 + r < Lq) {
          const size_t at = (static_cast<size_t>(b) * Lq + q0 + r) * H + h;
          m_out[at] = mx;
          s_out[at] = sum;
        }
      }
    }
  }

  // o = e . v, one 64-key chunk of V at a time
  constexpr int NC = D / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[j * D + d] = (k0 + j < Lk) ? vb[(k0 + j) * vrs + d] : 0.f;
    }
    __syncthreads();
    const int kn = min(kKC, Lk - k0);
    // The unroll of this loop moved the FMA body by up to 1.5x on the
    // H100, and not alike in the modes: the compiler's own choice suits
    // kStats, no unrolling kPlain.  The body is the same in both branches.
    if constexpr (M == FwdMode::kStats) {
      for (int j = 0; j < kn; ++j) {
        float e[4], vv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = sc_s[(ty * 4 + i) * ld_s + k0 + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = kv_s[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(e[i], vv[c], acc[i][c]);
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < kn; ++j) {
        float e[4], vv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = sc_s[(ty * 4 + i) * ld_s + k0 + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = kv_s[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(e[i], vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Lq) continue;
    const float s = sum_s[r];
    float* orow = o + ((static_cast<size_t>(b) * Lq + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / s;
  }
}

// ---- bf16: the tensor-core body ----------------------------------------

using bf16 = __nv_bfloat16;

// One warpgroup a block, 16 query rows a warp; four tiles in the ring.  On
// the H100, 128-row blocks (two warpgroups, or two row tiles a warp: half
// the K and V traffic from L2, fewer warps an SM) were slower, and so were
// rings of 2 and 6 stages: at 128 registers, four blocks an SM hide the
// latency best.
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows = kFwdBQ query rows
constexpr int kMmaStages = 4;     // K / V tiles in the ring
static_assert(kMmaThreads / 32 * 16 == kFwdBQ, "one 16-row tile a warp");

// row stride of a shared-memory tile, in elements: 16 bytes of padding put
// the 8 rows an ldmatrix reads on 8 different groups of 4 banks
template <int D> __host__ __device__ constexpr int mma_ld() { return D + 8; }

template <int D> __host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (1 + kMmaStages) * kFwdBQ * mma_ld<D>();  // Q tile + ring
}

// The log2-domain logits of one chunk of 16 * NP keys (64 by default) for a
// warp's 16 query rows: s[n] is the 16 x 8 tile of keys 8n..8n+7, summed over
// D in ascending k16 steps from zero.  qa holds the scaled q as A fragments;
// k_tile is the shared-memory address of the chunk's first key row.  The
// backward kernels (attention_bwd.cuh) call this same function, so their
// logits equal the forward's bit for bit: an element's sum does not depend
// on NP.
template <int D, int NP = 4>
__device__ __forceinline__ void chunk_logits(const uint32_t (&qa)[D / 16][4], uint32_t k_tile,
                                             int lane, float (&s)[2 * NP][4]) {
  constexpr int kRow = mma_ld<D>() * 2;  // bytes
  // lanes 0-7: keys 0-7, d 0-7; 8-15: keys 0-7, d 8-15; 16-23: keys 8-15,
  // d 0-7; 24-31: keys 8-15, d 8-15 -> b0, b1 of two adjacent key tiles
  const uint32_t base = k_tile + ((lane & 7) + ((lane >> 4) << 3)) * kRow + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int np = 0; np < NP; ++np) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, base + np * 16 * kRow + kk * 32);
      mma_bf16_16816(s[2 * np], qa[kk], b[0], b[1]);
      mma_bf16_16816(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
  }
}

// o[n] += p . v over one chunk of 16 * NKB keys (64 by default): pa the k16
// A fragments of p, v_tile the shared-memory address of the chunk's first V
// row
template <int D, int NKB = 4>
__device__ __forceinline__ void chunk_pv(const uint32_t (&pa)[NKB][4], uint32_t v_tile, int lane,
                                         float (&o)[D / 8][4]) {
  constexpr int kRow = mma_ld<D>() * 2;
  // transposed: lanes 0-7: keys 0-7, d 0-7; 8-15: keys 8-15, d 0-7;
  // 16-23: keys 0-7, d 8-15; 24-31: keys 8-15, d 8-15
  const uint32_t base = v_tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRow + (lane >> 4) * 16;
#pragma unroll
  for (int kb = 0; kb < NKB; ++kb) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, base + kb * 16 * kRow + dp * 32);
      mma_bf16_16816(o[2 * dp], pa[kb], b[0], b[1]);
      mma_bf16_16816(o[2 * dp + 1], pa[kb], b[2], b[3]);
    }
  }
}

// -inf at the keys at or past Lk of a chunk of 8 * NT keys starting at key
// k0; col0 is the thread's first key in each 8-key tile
template <int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int k0, int col0, int Lk) {
  if (k0 + NT * 8 <= Lk) return;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (k0 + n * 8 + col0 + c >= Lk) s[n][c] = s[n][c + 2] = -INFINITY;
}

template <FwdMode M>
__device__ __forceinline__ float exp_centred(float x, float m) {
  if constexpr (M == FwdMode::kBf16Exp) return round_t<bf16>(exp2f(round_t<bf16>(x - m)));
  return exp2f(x - m);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A fragments of a warp's 16 rows (rows 16 * warp ... + 15) of a padded
// [64, D] tile at shared-memory address `tile`, one k16 step each
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], uint32_t tile, int warp,
                                            int lane) {
  const uint32_t base = tile + ((warp * 16 + (lane & 15)) * mma_ld<D>() + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(a[kk], base + kk * 32);
}

// a * f rounded to bf16, element by element: q scaled in bf16 as the TPU
// kernels scale it.  Forward and backward scale through this one function,
// so their logits start from the same bits.
template <int D>
__device__ __forceinline__ void scale_a_rows(uint32_t (&a)[D / 16][4], float f) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack_bf16(a[kk][i]);
      a[kk][i] = pack_bf16(x.x * f, x.y * f);
    }
}

// the running max of this thread's rows g (mx[0]) and g + 8 (mx[1]) over one
// chunk's logits
__device__ __forceinline__ void chunk_row_max(const float (&s)[8][4], float (&mx)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
}

// Copies rows [r0, r0 + 64) of a [L, D] bf16 operand (row stride rs
// elements, 16-byte aligned) into a padded tile; rows at or past L are
// zero-filled and not read.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long rs, int r0,
                                          int L, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int i = 0; i < kFwdBQ * kChunks / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = c / kChunks, p = c % kChunks;
    const bool ok = r0 + r < L;
    const bf16* g = src + (ok ? (r0 + r) * rs : 0) + p * 8;
    cp_async_16(smem_addr(dst + r * mma_ld<D>() + p * 8), g, ok ? 16 : 0);
  }
}

// 128 registers a thread at D <= 64: four blocks an SM
template <int D, FwdMode M>
__global__ void __launch_bounds__(kMmaThreads, D >= 128 ? 2 : 4)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ s_out,
                    int Lq, int Lk, int H, int n_qb,
                    long long qbs, long long qrs, long long kbs, long long krs,
                    long long vbs, long long vrs, float qscale) {
  constexpr int kLd = mma_ld<D>();
  constexpr int kTile = kFwdBQ * kLd;  // elements of one tile: 64 rows of Q, K or V
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // Q tile, later o
  bf16* ring = q_s + kTile;                       // kMmaStages K / V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (blockIdx.x % n_qb) * kFwdBQ;
  const bf16* qg = q + b * qbs + h * D;
  const bf16* kg = k + b * kbs + h * D;
  const bf16* vg = v + b * vbs + h * D;

  // the tile stream: K chunks 0..nk-1 (sweep 1), then K0, V0, K1, V1, ...
  const int nk = (Lk + kFwdKC - 1) / kFwdKC;
  const int n_tiles = 3 * nk;
  auto load_tile = [&](int t) {
    bf16* dst = ring + (t % kMmaStages) * kTile;
    const int j = t < nk ? t : (t - nk) >> 1;
    if (t >= nk && ((t - nk) & 1))
      load_rows<D>(dst, vg, vrs, j * kFwdKC, Lk, tid);
    else
      load_rows<D>(dst, kg, krs, j * kFwdKC, Lk, tid);
  };
  load_rows<D>(q_s, qg, qrs, q0, Lq, tid);  // in the first group, with tile 0
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  // waits for the next tile, refills the stage every warp has finished
  // with, and returns the tile's shared-memory address
  int t_next = 0;
  auto next_tile = [&]() -> uint32_t {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int t = t_next++;
    if (t + kMmaStages - 1 < n_tiles) load_tile(t + kMmaStages - 1);
    cp_async_commit();
    return smem_addr(ring + (t % kMmaStages) * kTile);
  };

  uint32_t k_tile = next_tile();  // Q has arrived too

  // the warp's 16 rows of q, scaled in bf16 as the TPU kernel scales them,
  // kept as A fragments for both sweeps
  uint32_t qa[D / 16][4];
  load_a_rows<D>(qa, smem_addr(q_s), warp, lane);
  scale_a_rows<D>(qa, qscale);

  const int col0 = 2 * (lane & 3);
  // this thread's rows of the warp's 16: g and g + 8
  float mx[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < nk; ++j) {  // sweep 1: the row max
    if (j > 0) k_tile = next_tile();
    float s[8][4];
    chunk_logits<D>(qa, k_tile, lane, s);
    mask_keys(s, j * kFwdKC, col0, Lk);
    chunk_row_max(s, mx);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float sum[2] = {0.f, 0.f};
  for (int j = 0; j < nk; ++j) {  // sweep 2: e, s and o
    k_tile = next_tile();
    float s[8][4];
    chunk_logits<D>(qa, k_tile, lane, s);
    mask_keys(s, j * kFwdKC, col0, Lk);
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = exp_centred<M>(s[n][i], mx[i >> 1]);
        sum[i >> 1] += e[i];
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(e[0], e[1]);      // row g
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(e[2], e[3]);  // row g + 8
    }
    chunk_pv<D>(pa, next_tile(), lane, acc);
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);

  const int g = lane >> 2;
  const int row0 = q0 + warp * 16 + g;  // this thread's first row; the second is row0 + 8
  if constexpr (M == FwdMode::kStats) {
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        if (r < Lq) {
          const size_t at = (static_cast<size_t>(b) * Lq + r) * H + h;
          m_out[at] = mx[i];
          s_out[at] = sum[i];
        }
      }
    }
  }

  // o / s in bf16 through the warp's own rows of the Q tile, then 16-byte
  // stores of whole rows
  bf16* stage = q_s + warp * 16 * kLd;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * kLd + n * 8 + col0) =
        __floats2bfloat162_rn(acc[n][0] / sum[0], acc[n][1] / sum[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kLd + n * 8 + col0) =
        __floats2bfloat162_rn(acc[n][2] / sum[1], acc[n][3] / sum[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c / kChunks, p = c % kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < Lq)
      *reinterpret_cast<uint4*>(o + ((static_cast<size_t>(b) * Lq + row) * H + h) * D + p * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + p * 8);
  }
}

// ---- launch ----------------------------------------------------------------

// 16-byte copies need 16-byte aligned rows: base addresses and batch and
// row strides that are multiples of 8 bf16 elements (a stride of a size-1
// dimension is never used)
bool mma_operands_ok(const void* q, const void* k, const void* v, const void* o, int B, int Lq,
                     int Lk, long long qbs, long long qrs, long long kbs, long long krs,
                     long long vbs, long long vrs) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto stride_ok = [](long long s, int n) { return n == 1 || s % 8 == 0; };
  return aligned(q) && aligned(k) && aligned(v) && aligned(o) &&
         stride_ok(qbs, B) && stride_ok(kbs, B) && stride_ok(vbs, B) &&
         stride_ok(qrs, Lq) && stride_ok(krs, Lk) && stride_ok(vrs, Lk);
}

template <typename T, int D, FwdMode M>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o, float* m,
                       float* s, int B, int Lq, int Lk, int H, long long qbs,
                       long long qrs, long long kbs, long long krs, long long vbs,
                       long long vrs, float qscale, cudaStream_t stream) {
  const int n_qb = (Lq + kFwdBQ - 1) / kFwdBQ;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(n_qb) * B * H);
  if constexpr (std::is_same<T, bf16>::value) {
    if (!mma_operands_ok(q, k, v, o, B, Lq, Lk, qbs, qrs, kbs, krs, vbs, vrs))
      return cudaErrorMisalignedAddress;
    constexpr size_t smem = mma_smem_bytes<D>();
    auto kernel = attn_fwd_mma_kernel<D, M>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), m, s, Lq, Lk, H, n_qb, qbs, qrs, kbs, krs, vbs, vrs, qscale);
  } else {
    const size_t smem = fwd_smem_bytes(D, Lk);
    auto kernel = attn_fwd_fma_kernel<D, M>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kFwdThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), m, s, Lq, Lk, H, n_qb, qbs, qrs, kbs, krs, vbs, vrs, qscale);
  }
  return cudaGetLastError();
}

// head_dim in (32, 64, 128); the shape checks of the C entries come first
template <typename T, FwdMode M>
cudaError_t fwd_dispatch(int head_dim, const void* q, const void* k, const void* v,
                         void* o, float* m, float* s, int B, int Lq, int Lk, int H,
                         long long qbs, long long qrs, long long kbs, long long krs,
                         long long vbs, long long vrs, float qscale, cudaStream_t st) {
  switch (head_dim) {
    case 32: return fwd_launch<T, 32, M>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    case 64: return fwd_launch<T, 64, M>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    case 128: return fwd_launch<T, 128, M>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

// the launch limits both C entries check first: the 1-D grid, and the
// fp32 body's score tile in shared memory (the limit the wrapper checks
// for both dtypes)
bool fwd_shape_ok(int head_dim, int B, int Lq, int Lk, int H) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return false;
  if (static_cast<long long>((Lq + kFwdBQ - 1) / kFwdBQ) * B * H > INT_MAX) return false;
  return fwd_smem_bytes(head_dim, Lk) <= 232448;
}

}  // namespace
