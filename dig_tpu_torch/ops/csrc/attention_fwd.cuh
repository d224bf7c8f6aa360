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
// written, m and s written), 0.122 ms at 3.35 TB/s, against 51.5 GFLOP on
// the bf16 tensor cores (two products, 0.052 ms), and 201M exponentials on
// the special-function units.
//
// bf16: attn_fwd_wgmma_kernel, warp-specialised for Hopper, one persistent
// block an SM: a producer warpgroup and kFwdConsumers = 2 consumer
// warpgroups, which take work items of 128 query rows of one (b, h), 64
// each, against all keys (so each K and V tile fetched serves 128 rows):
//  * the producer's first thread loads each item's Q tiles and then its K
//    and V tiles (64 keys each) by TMA (cp.async.bulk.tensor) into a
//    128 KB ring of shared-memory stages, each completed on an mbarrier;
//    consumers wait on those barriers and hand a stage back on another, so
//    no __syncthreads orders a copy, and the next item's tiles arrive while
//    the consumers work.  The tensor maps read q, k and v as they arrive
//    (hopper.cuh make_head_map), rows past L as zeros, in TMA's swizzled
//    layout, which is what wgmma reads without bank conflicts;
//  * both products are wgmma (m64nNk16, bf16 operands, fp32 accumulators):
//    q . k^T with the scaled q as A fragments in registers and the K tile
//    K-major from shared memory; e . v with e packed to bf16 straight into
//    A fragments (never in shared memory) and the V tile N-major;
//  * setmaxnreg hands the producer's registers to the consumers (24 / 240
//    a thread), which hold the logits of the first kResidentTiles = 4 key
//    tiles (256 keys): for Lk in (192, 256], the model's sequences, a
//    consumer takes every tile's logits in one sweep over K, the exact row
//    max, then e, s and e . v tile by tile with V, so each K and V tile
//    crosses into shared memory once.  Tiles past the fourth (Lk = 281: a
//    fifth) are swept twice, as are all tiles for Lk <= 192 and D = 128
//    (whose accumulators leave no room): the row max, then the same logits
//    again (the same instructions, the same bits) for e, s and e . v;
//  * the two consumers take turns (named barriers) at the resident tiles'
//    exponentials and e . v, so one's special-function work overlaps the
//    other's logits, row max and stores; o is staged in the item's Q tile
//    and written by a TMA store.
// Online softmax (a running max, e and o rescaled as it moves) would need
// neither the resident logits nor the second sweep, but it rounds each e to
// bf16 against a max that is not yet the final one: on random inputs 3% of
// o then lies outside the tolerance the port holds the kernel to, against
// 4.5e-6 with the exact max (tools/attention_online_rounding.py, on the
// CPU).  The forward's wgmma logits equal the backward's mma.sync ones bit
// for bit on the card (chip_smoke.py's [logits probe]).
//
// fp32: attn_fwd_fma_kernel, the port's parity path (a tensor-core fp32
// product runs in TF32, about three digits).  One CTA of 256 threads owns
// 64 query rows against all keys; the 64 x Lk fp32 score tile stays in
// shared memory, so the softmax is exact in one pass; the products are
// fp32 FMAs from shared memory, summed in ascending D, and the row max and
// sum taken in one fixed order, as the backward kernels take them
// (attention_bwd.cuh).  Its shared memory sets the Lk limit the wrapper
// checks (fwd_smem_bytes).
//
// Also here: the mma.sync pieces (chunk_logits, chunk_pv, load_rows, ...)
// of the backward's tensor-core bodies (attention_bwd.cuh).
#pragma once

#include <limits.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
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

// ---- bf16: pieces shared with the backward's mma.sync bodies -------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // one warpgroup: 4 warps x 16 rows = kFwdBQ query rows
static_assert(kMmaThreads / 32 * 16 == kFwdBQ, "one 16-row tile a warp");

// row stride of a padded shared-memory tile (the backward's), in elements:
// 16 bytes of padding put the 8 rows an ldmatrix reads on 8 different
// groups of 4 banks
template <int D> __host__ __device__ constexpr int mma_ld() { return D + 8; }

// The log2-domain logits of one chunk of 16 * NP keys (64 by default) for a
// warp's 16 query rows by mma.sync: s[n] is the 16 x 8 tile of keys
// 8n..8n+7, summed over D in ascending k16 steps from zero.  qa holds the
// scaled q as A fragments; k_tile is the shared-memory address of the
// chunk's first key row in a padded tile.  The backward's sweeps take
// their logits and dw here; an element's sum does not depend on NP.
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

// exp2 of a centred logit (the forward's e, and the recompute backward's for
// its statistics); e below 2^-126 is 0
template <FwdMode M>
__device__ __forceinline__ float exp_centred(float x, float m) {
  if constexpr (M == FwdMode::kBf16Exp) return round_t<bf16>(ex2_ftz(round_t<bf16>(x - m)));
  return ex2_ftz(x - m);
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

// ---- bf16: the warp-specialised TMA / wgmma body ---------------------------

// Consumer warpgroups a block (64 query rows each, of one work item), and
// the key tiles whose logits a consumer holds in registers (the one-sweep
// path).  Two consumers a block serve 128 query rows with each K and V tile
// and take turns (below).
constexpr int kFwdConsumers = 2;
constexpr int kResidentTiles = 4;
static_assert(kResidentTiles <= 4, "wgmma_wait_static counts at most 3 groups");
// setmaxnreg budgets: one block an SM of three warpgroups, 168 registers a
// thread at launch; the producer keeps 24 and the consumers take the rest
constexpr int kFwdWgThreads = 128 * (kFwdConsumers + 1);
constexpr int kLaunchRegs = (65536 / kFwdWgThreads) & ~7;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    (((kFwdConsumers + 1) * kLaunchRegs - kProducerRegs) / kFwdConsumers) & ~7;
static_assert(kConsumerRegs <= 256, "setmaxnreg takes at most 256 registers");

// bytes of one swizzled [64, D] bf16 tile
template <int D> __host__ __device__ constexpr uint32_t tile_bytes() { return kFwdBQ * D * 2; }
// K / V tiles in the ring: 128 KB, two work items' K and V at D = 64 and
// Lk = 256, so the producer loads the next item while the consumers work
constexpr uint32_t kRingBytes = 128 * 1024;
template <int D> __host__ __device__ constexpr int fwd_stages() {
  return static_cast<int>(kRingBytes / tile_bytes<D>());
}

// two slots of Q tiles (a work item's, later its o), the ring, the ring's
// full and empty barriers and the Q slots', and 1024 bytes to align tiles
template <int D> __host__ __device__ constexpr size_t wg_smem_bytes() {
  return 1024 + (2 * kFwdConsumers + fwd_stages<D>()) * static_cast<size_t>(tile_bytes<D>()) +
         8 * (2 * fwd_stages<D>() + 4);
}

// byte offset of 16-byte chunk c (columns 8c..8c+7) of row r in a swizzled
// [64, D] tile (hopper.cuh)
template <int D>
__host__ __device__ __forceinline__ uint32_t sw_chunk(int r, int c) {
  if constexpr (D == 32) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  return (c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// the A fragments of a warp's 16 rows of a swizzled [64, D] tile
template <int D>
__device__ __forceinline__ void load_a_rows_sw(uint32_t (&a)[D / 16][4], uint32_t tile, int warp,
                                               int lane) {
  const int r = warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(a[kk], tile + sw_chunk<D>(r, 2 * kk + (lane >> 4)));
}

// The log2-domain logits of one 64-key tile for a warpgroup's 64 query rows
// by wgmma, issued and committed as one group (the caller fences the
// registers before and waits after): s in chunk_logits' layout (each warp
// its 16 rows), summed over D in ascending k16 steps from zero.  qa: the
// warp's rows of the scaled q as A fragments; k_tile: a swizzled K tile,
// read K-major.  On the H100 these are chunk_logits' bits for the same
// operands (chip_smoke.py's [logits probe]), which the backward relies on.
template <int D>
__device__ __forceinline__ void wg_logits_issue(const uint32_t (&qa)[D / 16][4], uint32_t k_tile,
                                                float (&s)[8][4]) {
  constexpr uint32_t kSbo = D == 32 ? 512 : 1024;  // 8 rows
  constexpr uint32_t kSwizzle = D == 32 ? 2 : 1;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = k_tile + (kk >> 2) * (64 * 128) + (kk & 3) * 32;
    WgmmaRS<64>::mma<0>(s, qa[kk], wgmma_desc(at, 16, kSbo, kSwizzle), kk > 0);
  }
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void wg_logits(const uint32_t (&qa)[D / 16][4], uint32_t k_tile,
                                          float (&s)[8][4]) {
  wgmma_fence();
  wg_logits_issue<D>(qa, k_tile, s);
  wgmma_wait<0>();
  fence_regs(s);
}

// o += p . v over one 64-key tile by wgmma, issued and committed: pa the
// A fragments of p (16 keys each), v_tile a swizzled V tile read N-major
// (the D = 128 halves 8 KB apart)
template <int D>
__device__ __forceinline__ void wg_pv_issue(const uint32_t (&pa)[4][4], uint32_t v_tile,
                                            float (&o)[D / 8][4]) {
  constexpr uint32_t kRow = (D > 64 ? 64 : D) * 2;  // bytes of one key's row
  constexpr uint32_t kSwizzle = D == 32 ? 2 : 1;
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    WgmmaRS<D>::template mma<1>(o, pa[kb], wgmma_desc(v_tile + kb * 16 * kRow, 64 * 128, 8 * kRow,
                                                      kSwizzle), 1);
  wgmma_commit();
}

// e = exp_centred(logit, m) in place over NT 8-key tiles, and the thread's
// row sums of e added key by key: the forward's statistics, and through the
// same function the recompute backward's (attention_bwd.cuh, 32 keys at a
// time, in the same key order), so their s agree bit for bit
template <FwdMode M, int NT>
__device__ __forceinline__ void tile_exp_sum(float (&s)[NT][4], const float (&mx)[2],
                                             float (&sum)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[n][i] = exp_centred<M>(s[n][i], mx[i >> 1]);
      sum[i >> 1] += s[n][i];
    }
}

// a tile's e rounded to bf16 as the A fragments of e . v, 16 keys each:
// the accumulators of two adjacent 8-key tiles are one k16 A fragment
__device__ __forceinline__ void pack_p(const float (&e)[8][4], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    pa[n >> 1][(n & 1) * 2] = pack_bf16(e[n][0], e[n][1]);      // row g
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(e[n][2], e[n][3]);  // row g + 8
  }
}

// A work item's tile stream, producer and consumers alike, with R key tiles
// resident (kResident: R = kResidentTiles; otherwise R = 0): K0 .. K(nk-1)
// (the max sweep), then V0 .. V(R-1), then K(R), V(R), K(R+1), V(R+1), ...
// (the tiles swept again).  Returns the key tile's index; is_v says whether
// the tile is V's.
template <bool kResident>
__device__ __forceinline__ int tile_key_block(int t, int nk, bool& is_v) {
  constexpr int R = kResident ? kResidentTiles : 0;
  if (t < nk) {
    is_v = false;
    return t;
  }
  if (t < nk + R) {
    is_v = true;
    return t - nk;
  }
  is_v = (t - nk - R) & 1;
  return R + ((t - nk - R) >> 1);
}

// The two consumer warpgroups take turns at the one-sweep body's e and
// e . v over the resident tiles, so that one's exponentials run while the
// other takes its logits, row max and stores (turns around the q . k^T
// issue instead measured 5% slower).  Named barrier 1 + w is warpgroup w's
// turn, which the other warpgroup passes to it.  A turn holds up the other
// warpgroup's releases, so it spans no more tiles than the ring holds:
// held over a whole second sweep, it deadlocked the ring.
static_assert(kFwdConsumers == 2, "the turns are a ping-pong of two warpgroups");
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
}

// A persistent grid: block i takes work items i, i + gridDim.x, ... of
// 64 * kFwdConsumers query rows of one (b, h), query block fastest, so the
// blocks working side by side share K and V through L2.
template <int D, FwdMode M, bool kResident>
__global__ void __launch_bounds__(kFwdWgThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                      float* __restrict__ m_out, float* __restrict__ s_out, int Lq, int Lk,
                      int H, int n_qb, int n_items, float qscale) {
  constexpr int kStages = fwd_stages<D>();
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr uint32_t kSlot = kFwdConsumers * kTile;  // one work item's Q tiles
  constexpr int kHalves = D > 64 ? 2 : 1;  // TMA boxes a tile: 128-byte rows at most
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023) & ~1023u;
  unsigned char* const base_p = wg_smem + (base - smem_addr(wg_smem));
  const uint32_t ring = base + 2 * kSlot;        // after the two Q slots
  const uint32_t bars = ring + kStages * kTile;  // full[kStages], empty[kStages], Q's
  auto full = [&](int t) { return bars + 8 * (t % kStages); };
  auto empty = [&](int t) { return bars + 8 * (kStages + t % kStages); };
  auto q_full = [&](int it) { return bars + 8 * (2 * kStages + (it & 1)); };
  auto q_empty = [&](int it) { return bars + 8 * (2 * kStages + 2 + (it & 1)); };

  const int nk = (Lk + kFwdKC - 1) / kFwdKC;
  const int n_tiles = 3 * nk - (kResident ? kResidentTiles : 0);  // a work item's K and V tiles

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);                     // the producer's arrival + the bytes
      mbar_init(empty(i), 4 * kFwdConsumers);  // every consumer warp
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * kFwdConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, as one value across its warps
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kFwdConsumers) {  // the producer warpgroup
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&to);
      int t = 0;  // the ring's tiles, counted across work items
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qb, b = bh / H, h = bh % H;
        const int q0 = (item % n_qb) * kFwdBQ * kFwdConsumers;
        if (it >= 2) mbar_wait(q_empty(it), ((it >> 1) - 1) & 1);
        mbar_expect_tx(q_full(it), kSlot);
#pragma unroll
        for (int c = 0; c < kFwdConsumers; ++c)
#pragma unroll
          for (int x = 0; x < kHalves; ++x)
            tma_load_4d(base + (it & 1) * kSlot + c * kTile + x * 8192, &tq, q_full(it), 64 * x,
                        h, q0 + kFwdBQ * c, b);
        for (int u = 0; u < n_tiles; ++u, ++t) {
          if (t >= kStages) mbar_wait(empty(t), (t / kStages - 1) & 1);
          bool is_v;
          const int j = tile_key_block<kResident>(u, nk, is_v);
          mbar_expect_tx(full(t), kTile);
          const uint32_t dst = ring + (t % kStages) * kTile;
#pragma unroll
          for (int x = 0; x < kHalves; ++x)
            tma_load_4d(dst + x * 8192, is_v ? &tv : &tk, full(t), 64 * x, h, kFwdKC * j, b);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows of each work item, 16 a warp
    regs_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, col0 = 2 * (lane & 3);
    int t = 0;  // the item's first tile in the ring's stream
    auto tile = [&](int u) {  // the item's tile u, once it has arrived
      mbar_wait(full(t + u), ((t + u) / kStages) & 1);
      return ring + ((t + u) % kStages) * kTile;
    };
    // after the warp's wgmma reads of the item's tile u have completed
    auto release = [&](int u) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(t + u));
    };
    if (wg == 1) turn_pass(1);  // the first turn is the first warpgroup's
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_qb, b = bh / H, h = bh % H;
      const int row_base = (item % n_qb) * kFwdBQ * kFwdConsumers + kFwdBQ * wg;
      const uint32_t q_tile = base + (it & 1) * kSlot + wg * kTile;
      mbar_wait(q_full(it), (it >> 1) & 1);
      if (row_base >= Lq) {  // a ragged item's spare warpgroup passes the tiles on
        turn_wait(wg);
        turn_pass(wg);
        for (int u = 0; u < n_tiles; ++u) {
          tile(u);
          release(u);
        }
      } else {
        // the warp's 16 rows of q, scaled in bf16 as the TPU kernel scales them
        uint32_t qa[D / 16][4];
        load_a_rows_sw<D>(qa, q_tile, warp, lane);
        scale_a_rows<D>(qa, qscale);
        // this thread's rows of the warp's 16: g and g + 8
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
        float acc[D / 8][4];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
        // key tile j's logits again from the item's tile u, its e, sums and
        // e . v with V from tile u + 1
        auto exp_pv_again = [&](int j, int u) {
          float x[8][4];
          wg_logits<D>(qa, tile(u), x);
          release(u);
          mask_keys(x, kFwdKC * j, col0, Lk);
          tile_exp_sum<M>(x, mx, sum);
          uint32_t pb[4][4];
          pack_p(x, pb);
          wg_pv_issue<D>(pb, tile(u + 1), acc);
          wgmma_wait<0>();
          fence_regs(acc);
          release(u + 1);
        };
        if constexpr (kResident) {  // one sweep: the first tiles' logits in registers
          // One fence for these products (no thread touches qa or s while
          // they run), and no branch among them: a run-time guard around a
          // product made ptxas serialise every wgmma of the body.
          float s[kResidentTiles][8][4];
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kResidentTiles; ++j) wg_logits_issue<D>(qa, tile(j), s[j]);
          // each tile's max while the later tiles' products run
#pragma unroll
          for (int j = 0; j < kResidentTiles; ++j) {
            wgmma_wait_static(kResidentTiles - 1 - j);
            fence_regs(s[j]);
            release(j);
            mask_keys(s[j], kFwdKC * j, col0, Lk);
            chunk_row_max(s[j], mx);
          }
          for (int j = kResidentTiles; j < nk; ++j) {  // tiles past the resident ones
            float x[8][4];
            wg_logits<D>(qa, tile(j), x);
            release(j);
            mask_keys(x, kFwdKC * j, col0, Lk);
            chunk_row_max(x, mx);
          }
          mx[0] = quad_max(mx[0]);
          mx[1] = quad_max(mx[1]);
          // e and e . v tile by tile, in this warpgroup's turn (forming a
          // tile's e while the previous tile's product ran measured the same)
          static_assert(kResidentTiles <= fwd_stages<D>(), "a turn spans the ring at most");
          turn_wait(wg);
#pragma unroll
          for (int j = 0; j < kResidentTiles; ++j) {
            tile_exp_sum<M>(s[j], mx, sum);
            uint32_t pa[4][4];
            pack_p(s[j], pa);
            wg_pv_issue<D>(pa, tile(nk + j), acc);
            wgmma_wait<0>();
            fence_regs(acc);
            release(nk + j);
          }
          turn_pass(wg);
          for (int j = kResidentTiles; j < nk; ++j)  // their logits again, e and e . v
            exp_pv_again(j, nk + kResidentTiles + 2 * (j - kResidentTiles));
        } else {  // two sweeps: the row max, then the same logits again
          turn_wait(wg);
          turn_pass(wg);
          for (int j = 0; j < nk; ++j) {
            float x[8][4];
            wg_logits<D>(qa, tile(j), x);
            release(j);
            mask_keys(x, kFwdKC * j, col0, Lk);
            chunk_row_max(x, mx);
          }
          mx[0] = quad_max(mx[0]);
          mx[1] = quad_max(mx[1]);
          for (int j = 0; j < nk; ++j) exp_pv_again(j, nk + 2 * j);
        }
        sum[0] = quad_sum(sum[0]);
        sum[1] = quad_sum(sum[1]);

        // o / s in bf16 (one reciprocal a row: 32 divisions took a quarter
        // of an item's time) into the warp's own rows of its Q tile, in the
        // tile's swizzled layout, then one TMA store of the warp's 16 rows
        // (rows past Lq are not written)
        unsigned char* const stage = base_p + (q_tile - base);
        const float rs0 = 1.f / sum[0], rs1 = 1.f / sum[1];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(stage + sw_chunk<D>(warp * 16 + g, n) + col0 * 2) =
              pack_bf16(acc[n][0] * rs0, acc[n][1] * rs0);
          *reinterpret_cast<uint32_t*>(stage + sw_chunk<D>(warp * 16 + g + 8, n) + col0 * 2) =
              pack_bf16(acc[n][2] * rs1, acc[n][3] * rs1);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          constexpr uint32_t kRowBytes = (D > 64 ? 64 : D) * 2;
#pragma unroll
          for (int x = 0; x < kHalves; ++x)
            tma_store_4d(&to, q_tile + x * 8192 + warp * 16 * kRowBytes, 64 * x, h,
                         row_base + warp * 16, b);
          bulk_commit();
        }
        // m and s after the o store: the proxy fence above would wait on them
        const int row0 = row_base + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
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
      }
      t += n_tiles;
      // the Q slot back to the producer, once the o store has read it
      if (lane == 0) bulk_wait_read();
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(it));
    }
  }
}

// ---- launch ----------------------------------------------------------------

// TMA and the 16-byte stores need 16-byte aligned rows: base addresses, and
// batch and row strides that are multiples of 8 bf16 elements (a stride of
// a size-1 dimension is never used)
bool mma_operands_ok(const void* q, const void* k, const void* v, const void* o, int B, int Lq,
                     int Lk, long long qbs, long long qrs, long long kbs, long long krs,
                     long long vbs, long long vrs) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto stride_ok = [](long long s, int n) { return n == 1 || s % 8 == 0; };
  return aligned(q) && aligned(k) && aligned(v) && aligned(o) &&
         stride_ok(qbs, B) && stride_ok(kbs, B) && stride_ok(vbs, B) &&
         stride_ok(qrs, Lq) && stride_ok(krs, Lk) && stride_ok(vrs, Lk);
}

// Whether the compiled kernel's registers at launch cover the setmaxnreg
// budgets; a consumer asking for more than the block holds would wait
// forever, so such a kernel is refused instead of launched.
template <typename K>
cudaError_t check_reg_budget(K kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return (kFwdConsumers + 1) * attr.numRegs >= kProducerRegs + kFwdConsumers * kConsumerRegs
             ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int D, FwdMode M, bool kResident>
cudaError_t wgmma_launch(const void* q, const void* k, const void* v, void* o, float* m,
                         float* s, int B, int Lq, int Lk, int H, long long qbs, long long qrs,
                         long long kbs, long long krs, long long vbs, long long vrs,
                         float qscale, cudaStream_t stream) {
  // o is contiguous [B, Lq, H, D], stored 16 rows (a warp's) a box
  CUtensorMap tq, tk, tv, to;
  if (!make_head_map(&tq, q, D, H, Lq, B, qrs, qbs, kFwdBQ) ||
      !make_head_map(&tk, k, D, H, Lk, B, krs, kbs, kFwdKC) ||
      !make_head_map(&tv, v, D, H, Lk, B, vrs, vbs, kFwdKC) ||
      !make_head_map(&to, o, D, H, Lq, B, static_cast<long long>(H) * D,
                     static_cast<long long>(Lq) * H * D, 16))
    return cudaErrorInvalidValue;
  auto kernel = attn_fwd_wgmma_kernel<D, M, kResident>;
  static const cudaError_t budget = check_reg_budget(kernel);
  if (budget != cudaSuccess) return budget;
  constexpr size_t smem = wg_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int n_qb = (Lq + kFwdBQ * kFwdConsumers - 1) / (kFwdBQ * kFwdConsumers);
  const long long n_items = static_cast<long long>(n_qb) * B * H;
  const int blocks = static_cast<int>(std::min<long long>(n_items, sms));
  kernel<<<blocks, kFwdWgThreads, smem, stream>>>(tq, tk, tv, to, m, s, Lq, Lk, H, n_qb,
                                                  static_cast<int>(n_items), qscale);
  return cudaGetLastError();
}

template <typename T, int D, FwdMode M>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o, float* m,
                       float* s, int B, int Lq, int Lk, int H, long long qbs,
                       long long qrs, long long kbs, long long krs, long long vbs,
                       long long vrs, float qscale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (!mma_operands_ok(q, k, v, o, B, Lq, Lk, qbs, qrs, kbs, krs, vbs, vrs))
      return cudaErrorMisalignedAddress;
    if constexpr (D <= 64) {
      if (Lk > (kResidentTiles - 1) * kFwdKC)
        return wgmma_launch<D, M, true>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs,
                                        vrs, qscale, stream);
    }
    return wgmma_launch<D, M, false>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs,
                                     vrs, qscale, stream);
  } else {
    const int n_qb = (Lq + kFwdBQ - 1) / kFwdBQ;
    const size_t smem = fwd_smem_bytes(D, Lk);
    auto kernel = attn_fwd_fma_kernel<D, M>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(static_cast<long long>(n_qb) * B * H), kFwdThreads, smem,
             stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), m, s, Lq, Lk, H, n_qb, qbs, qrs, kbs, krs, vbs, vrs, qscale);
    return cudaGetLastError();
  }
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
