// The multi-head attention backward bodies shared by attention_lse_bwd.cu
// (from the forward's stored row statistics; replaces the TPU kernel
// dig_tpu/ops/attention.py::_attn_bwd_kernel_lse) and attention_bwd.cu
// (kRecompute: takes the statistics again from the logits; replaces
// dig_tpu/ops/attention.py::_attn_bwd_kernel).  For each (batch b, head h),
// with m and s the fp32 row max and exp2-sum of the logits:
//   logits = (q * (scale * log2e)) . k^T   q scaled in q's dtype, fp32 sums
//   e      = exp2(logits - m);  rs = 1 / s
//   dv     = (e in v's dtype)^T . (do * rs in v's dtype)
//   dw     = (do in v's dtype) . v^T
//   c      = rowsum(dw * e) * rs
//   ds0    = e * (dw - c), rounded to q's dtype
//   dq     = ds0 . k * (scale * rs)
//   dk     = ds0^T . (q * scale * rs in q's dtype)
// with fp32 sums throughout and every rounding where the TPU kernels round.
//
// The TPU kernels hold one head's whole 256 x 256 fp32 score tile in VMEM
// and sum dk, dv over the query rows and dq over the keys in one body.  A
// Hopper CTA has 227 KB, so the two reductions are two launches, as in
// FlashAttention-2, and neither uses atomics (the same bits every run):
//  1. a row pass over the query rows against all Lk keys: dq, and c into a
//     small fp32 [B, Lq, H] scratch for the second pass.  With kRecompute
//     it takes m and s itself, through the forward kernel's own statistics
//     functions, and writes them beside c; otherwise it reads the forward's.
//  2. a column pass over the keys that walks the queries in 64-row tiles,
//     forms e and ds0 again from m, s and c, and sums dk and dv.
// q, k, v, do and the three gradients are addressed through batch and row
// strides, so column slices of the packed qkv [B, L, 3*H*D] and of its
// gradient are read and written in place.
//
// What bounds it on an H100: bytes.  At the pre-training shapes (B = 256,
// L = 256, H = 6, D = 64, bf16) the function moves 355 MB (q, k, v, do read,
// dq, dk, dv written, m and s read), 0.106 ms at 3.35 TB/s, against 5
// products of 2*B*H*L*L*D (64 GFLOP, 0.065 ms on the bf16 tensor cores).
// Two passes read q, k, v and do twice: 0.15 ms at the peak rate.
//
// bf16: attn_bwd_rows_kernel and attn_bwd_cols_kernel, each the forward's
// block (attention_fwd.cuh): one persistent block an SM, a producer
// warpgroup and two consumer warpgroups (setmaxnreg moves the producer's
// registers to them), every tile by TMA (tensor maps over the packed
// columns, rows past L as zeros) into an mbarrier ring, every product a
// wgmma with bf16 operands and fp32 accumulators; no mma.sync, ldmatrix or
// cp.async.  A work item is 128 rows (two consumers x 64) of one (b, h).
//  * row pass: the producer's thread loads an item's Q and dO tiles and
//    then the K and V tiles, in the order rows_tile gives.  A consumer's
//    logits are the forward's wg_logits (the scaled q as A fragments, K
//    read K-major), so m is the exact max of the forward's logits (e <= 1)
//    and kRecompute's m and s, taken with the forward's chunk_row_max and
//    tile_exp_sum in the forward's key order, are the ones #3 stores: #2
//    equals #4 bit for bit.  Up to four key tiles (Lk <= 256, D <= 64) the
//    consumer keeps their logits in registers (128 of them): sweep 1 takes
//    them (and kRecompute's max, with no other product), then e; sweep 2
//    takes dw = do . v^T with both operands from shared memory and
//    rowsum(dw * e); sweep 3 takes dw again, forms ds0 = bf16(e * (dw - c))
//    straight into A fragments and sums dq = ds0 . k with the K tile read
//    N-major.  4 products a key tile, for #4 and #2 alike (5 and 6 in the
//    mma.sync body before); tiles past the fourth, and every tile at
//    D = 128, take their logits again in sweeps 2 and 3.  dq leaves by a
//    TMA store through the consumer's Q tile;
//  * column pass: a consumer keeps its 64 keys' K and V tiles in shared
//    memory and dk, dv in registers while the query tiles stream past, and
//    takes logits^T = k . (q * qscale)^T and dw^T = v . do^T with the keys
//    as rows, both operands from shared memory: the accumulators of e and
//    ds0 are then the A fragments of dv += e^T . bf16(do * rs) and dk +=
//    ds0^T . bf16(q * scale * rs), 4 products a tile, with no transpose
//    through shared memory and no barrier among the consumers.  Three
//    warps of the producer warpgroup form each query tile's scaled copies
//    (bf16(q * qscale) in place, bf16(q * scale * rs), bf16(do * rs)) and
//    its rows' m, 1 / s and c in shared memory, the fourth loads the tiles.
//    These logits equal the forward's bit for bit on the H100 with the
//    roles swapped and both operands in shared memory (chip_smoke.py's
//    [logits probe], which checks every form this file takes);
//  * both grids walk work items with the row (key) block fastest, so the
//    blocks of one (b, h) run side by side and share K, V (Q, dO) in L2.
//
// fp32: attn_bwd_dq_kernel and attn_bwd_dkdv_kernel, the port's parity path
// (a tensor-core fp32 product runs in TF32).  One CTA of 256 threads; the
// dq pass keeps the 64 x Lk fp32 tiles e and dw in shared memory (2 x 64 KB
// at Lk = 256), which sets the Lk limit the wrapper checks for both dtypes;
// products are fp32 FMAs from shared memory, summed in ascending D in both
// passes and in the fp32 forward, so kRecompute is bitwise the
// stored-statistics result here too.
#pragma once

#include <limits.h>
#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "attention_fwd.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdBQ = 64;  // query rows of a tile: a CTA's (fp32 dq pass), a consumer's (bf16)
constexpr int kBwdKC = 64;  // keys of a tile: a CTA's (fp32 dk/dv pass), a consumer's (bf16)

// batch and row strides, in elements, of every [B, L, H, D] operand
struct Strides {
  long long qb, qr, kb, kr, vb, vr, gb, gr, dqb, dqr, dkb, dkr, dvb, dvr;
};

size_t dq_smem_bytes(int head_dim, int lk) {
  return sizeof(float) * (static_cast<size_t>(kBwdBQ) * (head_dim + 1) +
                          static_cast<size_t>(head_dim) * (kBwdKC + 1) +
                          2 * static_cast<size_t>(kBwdBQ) * (lk + 1) + 2 * kBwdBQ);
}

size_t dkdv_smem_bytes(int head_dim) {
  return sizeof(float) * (2 * static_cast<size_t>(kBwdKC) * (head_dim + 1) +
                          2 * static_cast<size_t>(head_dim) * (kBwdBQ + 1) +
                          2 * static_cast<size_t>(kBwdKC) * (kBwdBQ + 1) + 3 * kBwdBQ);
}

// ---- fp32: the FMA body ------------------------------------------------
// In fp32 the roundings to the input dtype that the TPU kernels make are
// the identity, so none is written out.

// Pass 1: dq and c for kBQ query rows of one (b, h).  m and s are read
// (stored statistics) or written (kRecompute).
template <int D, bool kRecompute>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   float* __restrict__ m_io, float* __restrict__ s_io,
                   float* __restrict__ dq, float* __restrict__ c_out, int Lq, int Lk,
                   int H, Strides st, float qscale, float scale) {
  constexpr int kThreads = kBwdThreads, kBQ = kBwdBQ, kKC = kBwdKC;
  extern __shared__ float smem[];
  const int ld = Lk + 1;
  float* a_s = smem;                   // [kBQ][D + 1]: scaled q, then do
  float* kv_s = a_s + kBQ * (D + 1);   // K^T / V^T chunk [D][kKC + 1], or K chunk [kKC][D]
  float* e_s = kv_s + D * (kKC + 1);   // [kBQ][Lk + 1]: (logits, then) e, then ds0
  float* w_s = e_s + kBQ * ld;         // [kBQ][Lk + 1]: dw
  float* m_s = w_s + kBQ * ld;         // [kBQ]
  float* rs_s = m_s + kBQ;             // [kBQ]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const float* qb = q + b * st.qb + h * D;
  const float* kb = k + b * st.kb + h * D;
  const float* vb = v + b * st.vb + h * D;
  const float* gb = g + b * st.gb + h * D;

  if constexpr (!kRecompute) {
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool ok = q0 + r < Lq;
      const size_t at = (static_cast<size_t>(b) * Lq + q0 + r) * H + h;
      m_s[r] = ok ? m_io[at] : 0.f;
      rs_s[r] = ok ? 1.f / s_io[at] : 0.f;
    }
  }
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float val = 0.f;
    if (q0 + r < Lq) val = qb[(q0 + r) * st.qr + d] * qscale;
    a_s[r * (D + 1) + d] = val;
  }

  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  // e = exp2(logits - m) (or, with kRecompute, the logits), one 64-key chunk at a time
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[d * (kKC + 1) + j] = (k0 + j < Lk) ? kb[(k0 + j) * st.kr + d] : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = a_s[(ty * 4 + i) * (D + 1) + d];
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
        const int r = ty * 4 + i, col = k0 + tx + 16 * j;
        if (col < Lk) {
          if constexpr (kRecompute) e_s[r * ld + col] = acc[i][j];
          else e_s[r * ld + col] = exp2f(acc[i][j] - m_s[r]);
        }
      }
  }
  __syncthreads();

  if constexpr (kRecompute) {
    // the row max and exp2-sum, taken in the forward kernel's order; one warp per row
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* row = e_s + r * ld;
      float mx = -INFINITY;
      for (int col = lane; col < Lk; col += 32) mx = fmaxf(mx, row[col]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int col = lane; col < Lk; col += 32) {
        const float e = exp2f(row[col] - mx);
        row[col] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const bool ok = q0 + r < Lq;
        rs_s[r] = ok ? 1.f / sum : 0.f;
        if (ok) {
          const size_t at = (static_cast<size_t>(b) * Lq + q0 + r) * H + h;
          m_io[at] = mx;
          s_io[at] = sum;
        }
      }
    }
    // rs_s is next read after the barriers of the dw loop below
  }

  // a_s = do
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    a_s[r * (D + 1) + d] = (q0 + r < Lq) ? gb[(q0 + r) * st.gr + d] : 0.f;
  }

  // dw = do . v^T, one 64-key chunk at a time
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[d * (kKC + 1) + j] = (k0 + j < Lk) ? vb[(k0 + j) * st.vr + d] : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float gv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = a_s[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = kv_s[d * (kKC + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], vv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col < Lk) w_s[(ty * 4 + i) * ld + col] = acc[i][j];
      }
  }
  __syncthreads();

  // c = rowsum(dw * e) * rs and ds0 = e * (dw - c) in q's precision: one warp per row
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float* er = e_s + r * ld;
    const float* wr = w_s + r * ld;
    float sum = 0.f;
    for (int col = lane; col < Lk; col += 32) sum += wr[col] * er[col];
    const float c = warp_sum(sum) * rs_s[r];
    for (int col = lane; col < Lk; col += 32) er[col] = er[col] * (wr[col] - c);
    if (lane == 0 && q0 + r < Lq) c_out[(static_cast<size_t>(b) * Lq + q0 + r) * H + h] = c;
  }

  // dq = ds0 . k * (scale * rs), one 64-key chunk of K at a time
  constexpr int NC = D / 16;
  float acc[4][NC] = {};
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[j * D + d] = (k0 + j < Lk) ? kb[(k0 + j) * st.kr + d] : 0.f;
    }
    __syncthreads();
    const int kn = min(kKC, Lk - k0);
    for (int j = 0; j < kn; ++j) {
      float ds[4], kk[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = e_s[(ty * 4 + i) * ld + k0 + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = kv_s[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Lq) continue;
    const float f = scale * rs_s[r];
    float* row = dq + b * st.dqb + (q0 + r) * st.dqr + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[i][c] * f;
  }
}

// Pass 2: dk and dv for kKC keys of one (b, h), summed over all queries.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ m_in, const float* __restrict__ s_in,
                     const float* __restrict__ c_in, float* __restrict__ dk,
                     float* __restrict__ dv, int Lq, int Lk, int H, Strides st,
                     float qscale, float scale) {
  constexpr int kThreads = kBwdThreads, kBQ = kBwdBQ, kKC = kBwdKC;
  extern __shared__ float smem[];
  constexpr int ldq = kBQ + 1;
  float* k_s = smem;                    // [kKC][D + 1] this CTA's keys
  float* v_s = k_s + kKC * (D + 1);     // [kKC][D + 1] this CTA's values
  float* a_s = v_s + kKC * (D + 1);     // scaled q^T [D][kBQ + 1], then [kBQ][D] q * scale * rs
  float* o_s = a_s + D * ldq;           // do^T [D][kBQ + 1], then [kBQ][D] do * rs
  float* p_s = o_s + D * ldq;           // [kKC][kBQ + 1] e in v's precision
  float* g_s = p_s + kKC * ldq;         // [kKC][kBQ + 1] ds0
  float* m_s = g_s + kKC * ldq;         // [kBQ]
  float* rs_s = m_s + kBQ;              // [kBQ]
  float* c_s = rs_s + kBQ;              // [kBQ]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int j0 = blockIdx.y * kKC;
  const float* qb = q + b * st.qb + h * D;
  const float* kb = k + b * st.kb + h * D;
  const float* vb = v + b * st.vb + h * D;
  const float* gb = g + b * st.gb + h * D;

  for (int idx = tid; idx < kKC * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    const bool ok = j0 + j < Lk;
    k_s[j * (D + 1) + d] = ok ? kb[(j0 + j) * st.kr + d] : 0.f;
    v_s[j * (D + 1) + d] = ok ? vb[(j0 + j) * st.vr + d] : 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // key rows ty*4.., query / D columns tx + 16*c
  constexpr int NC = D / 16;
  float acc_dk[4][NC] = {}, acc_dv[4][NC] = {};

  for (int i0 = 0; i0 < Lq; i0 += kBQ) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool ok = i0 + r < Lq;
      const size_t at = (static_cast<size_t>(b) * Lq + i0 + r) * H + h;
      m_s[r] = ok ? m_in[at] : 0.f;
      rs_s[r] = ok ? 1.f / s_in[at] : 0.f;
      c_s[r] = ok ? c_in[at] : 0.f;
    }
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      const bool ok = i0 + i < Lq;
      a_s[d * ldq + i] = ok ? qb[(i0 + i) * st.qr + d] * qscale : 0.f;
      o_s[d * ldq + i] = ok ? gb[(i0 + i) * st.gr + d] : 0.f;
    }
    __syncthreads();

    // logits^T and dw^T for (key ty*4 + jj, query tx + 16*ii), summed as in pass 1
    float sacc[4][4] = {}, wacc[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kq[4], vq[4], qa[4], ga[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kq[jj] = k_s[(ty * 4 + jj) * (D + 1) + d];
        vq[jj] = v_s[(ty * 4 + jj) * (D + 1) + d];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        qa[ii] = a_s[d * ldq + tx + 16 * ii];
        ga[ii] = o_s[d * ldq + tx + 16 * ii];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          sacc[jj][ii] = fmaf(qa[ii], kq[jj], sacc[jj][ii]);
          wacc[jj][ii] = fmaf(ga[ii], vq[jj], wacc[jj][ii]);
        }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = tx + 16 * ii, j = ty * 4 + jj;
        const bool ok = i0 + i < Lq;
        const float e = exp2f(sacc[jj][ii] - m_s[i]);
        p_s[j * ldq + i] = ok ? e : 0.f;
        g_s[j * ldq + i] = ok ? e * (wacc[jj][ii] - c_s[i]) : 0.f;
      }
    __syncthreads();

    // the right-hand operands, row-major, in the input's precision
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      const bool ok = i0 + i < Lq;
      const float rs = rs_s[i];
      a_s[i * D + d] = ok ? qb[(i0 + i) * st.qr + d] * (scale * rs) : 0.f;
      o_s[i * D + d] = ok ? gb[(i0 + i) * st.gr + d] * rs : 0.f;
    }
    __syncthreads();

    const int qn = min(kBQ, Lq - i0);
    for (int i = 0; i < qn; ++i) {
      float pv[4], gv[4], qv[NC], ov[NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        pv[jj] = p_s[(ty * 4 + jj) * ldq + i];
        gv[jj] = g_s[(ty * 4 + jj) * ldq + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        qv[c] = a_s[i * D + tx + 16 * c];
        ov[c] = o_s[i * D + tx + 16 * c];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_dv[jj][c] = fmaf(pv[jj], ov[c], acc_dv[jj][c]);
          acc_dk[jj][c] = fmaf(gv[jj], qv[c], acc_dk[jj][c]);
        }
    }
  }

#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = ty * 4 + jj;
    if (j0 + j >= Lk) continue;
    float* krow = dk + b * st.dkb + (j0 + j) * st.dkr + h * D;
    float* vrow = dv + b * st.dvb + (j0 + j) * st.dvr + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      krow[tx + 16 * c] = acc_dk[jj][c];
      vrow[tx + 16 * c] = acc_dv[jj][c];
    }
  }
}

// ---- bf16: the Hopper bodies ---------------------------------------------

static_assert(kBwdBQ == kFwdBQ && kBwdKC == kFwdKC, "the forward's tiles");

// Both passes are the forward's block (attention_fwd.cuh): a producer
// warpgroup and kFwdConsumers = 2 consumer warpgroups, one persistent block
// an SM, tiles by TMA into mbarrier rings, every product a wgmma.
constexpr int kBwdConsumers = kFwdConsumers;
// The column pass's producer warpgroup also forms the scaled query tiles
// (three of its warps), so it keeps more registers than the row pass's.
constexpr int kColProducerRegs = 56;
constexpr int kColConsumerRegs =
    (((kBwdConsumers + 1) * kLaunchRegs - kColProducerRegs) / kBwdConsumers) & ~7;
static_assert(kColConsumerRegs <= 256, "setmaxnreg takes at most 256 registers");
// shared memory both passes fill, beside the 1024 bytes of alignment and
// the barriers: each pass's slots and ring
constexpr uint32_t kBwdTileBytes = 192 * 1024;

// d = a . b^T over D for two swizzled [64, D] tiles, both read K-major from
// shared memory, issued into the caller's group (no fence, no commit)
template <int D>
__device__ __forceinline__ void wg_ss_issue(uint32_t a_tile, uint32_t b_tile, float (&d)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    WgmmaSS64::mma(d, kmajor_desc<D>(a_tile, kk), kmajor_desc<D>(b_tile, kk), kk > 0);
}

template <int D>
__device__ __forceinline__ void wg_ss(uint32_t a_tile, uint32_t b_tile, float (&d)[8][4]) {
  wgmma_fence();
  wg_ss_issue<D>(a_tile, b_tile, d);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// The A fragments of a warp's 16 rows of a swizzled [64, D] tile by 32-bit
// shared-memory loads: the values load_a_rows_sw takes by ldmatrix
template <int D>
__device__ __forceinline__ void load_a_rows_lds(uint32_t (&a)[D / 16][4], const unsigned char* tile,
                                                int warp, int lane) {
  const int r = warp * 16 + (lane >> 2), t4 = 4 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(tile + sw_chunk<D>(r, 2 * kk) + t4);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(tile + sw_chunk<D>(r + 8, 2 * kk) + t4);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(tile + sw_chunk<D>(r, 2 * kk + 1) + t4);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(tile + sw_chunk<D>(r + 8, 2 * kk + 1) + t4);
  }
}

// the warp's 16 rows of q scaled in bf16 as the forward scales them
template <int D>
__device__ __forceinline__ void scaled_q_rows(uint32_t (&qa)[D / 16][4], const unsigned char* tile,
                                              int warp, int lane, float qscale) {
  load_a_rows_lds<D>(qa, tile, warp, lane);
  scale_a_rows<D>(qa, qscale);
}

// ds0 = e * (dw - c) of an 8-tile accumulator block, rounded to bf16 as the
// A fragments of a product over its 64 columns (pack_p's layout); c[0] is
// row g's, c[1] row g + 8's
__device__ __forceinline__ void pack_ds(const float (&e)[8][4], const float (&w)[8][4],
                                        const float (&c)[2], uint32_t (&da)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = e[n][i] * (w[n][i] - c[i >> 1]);
    da[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
    da[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
  }
}

// ---- the row pass: dq and c (and m, s with kRecompute) ----------------------

// a work item's Q and dO tiles, one of each a consumer warpgroup
template <int D> __host__ __device__ constexpr uint32_t rows_slot_bytes() {
  return 2 * kBwdConsumers * tile_bytes<D>();
}
template <int D> __host__ __device__ constexpr int rows_stages() {
  return static_cast<int>((kBwdTileBytes - 2 * rows_slot_bytes<D>()) / tile_bytes<D>());
}
template <int D> __host__ __device__ constexpr size_t rows_smem_bytes() {
  return 1024 + kBwdTileBytes + 8 * (2 * rows_stages<D>() + 4);
}

// A row-pass work item's K / V tile stream, producer and consumers alike,
// with R key tiles resident (kResident: R = kResidentTiles, else 0).
//   sweep 1 (logits): K0 .. K(R-1), and with kRecompute K(R) .. K(nk-1)
//     for the row max;
//   sweep 2 (c): V0 .. V(R-1), then K(j), V(j) for j >= R;
//   sweep 3 (dq): V(j), K(j) for j < R, then K(j), V(j) for j >= R.
// Returns the key tile's index; is_v says whether the tile is V's.
template <bool kRecompute, bool kResident>
__host__ __device__ __forceinline__ int rows_tile(int u, int nk, bool& is_v) {
  constexpr int R = kResident ? kResidentTiles : 0;
  const int n1 = kRecompute ? nk : R;
  if (u < n1) {
    is_v = false;
    return u;
  }
  u -= n1;
  if (u < R) {
    is_v = true;
    return u;
  }
  u -= R;
  if (u < 2 * (nk - R)) {
    is_v = u & 1;
    return R + (u >> 1);
  }
  u -= 2 * (nk - R);
  if (u < 2 * R) {
    is_v = !(u & 1);
    return u >> 1;
  }
  u -= 2 * R;
  is_v = u & 1;
  return R + (u >> 1);
}

template <bool kRecompute, bool kResident>
__host__ __device__ constexpr int rows_tile_count(int nk) {
  constexpr int R = kResident ? kResidentTiles : 0;
  return (kRecompute ? nk : R) + R + 2 * (nk - R) + 2 * nk;
}

// Work items of 64 * kBwdConsumers query rows of one (b, h), query block
// fastest, over a persistent grid, as the forward's.
template <int D, bool kRecompute, bool kResident>
__global__ void __launch_bounds__(kFwdWgThreads, 1)
attn_bwd_rows_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tdq, float* __restrict__ m_io,
                     float* __restrict__ s_io, float* __restrict__ c_out, int Lq, int Lk, int H,
                     int n_qb, int n_items, float qscale, float scale) {
  constexpr int kStages = rows_stages<D>();
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr uint32_t kSlot = rows_slot_bytes<D>();
  constexpr int kHalves = D > 64 ? 2 : 1;
  constexpr int R = kResident ? kResidentTiles : 0;
  static_assert(kStages >= kResidentTiles, "sweep 1 holds the resident tiles at once");
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t base = (smem_addr(bwd_smem) + 1023) & ~1023u;
  unsigned char* const base_p = bwd_smem + (base - smem_addr(bwd_smem));
  const uint32_t ring = base + 2 * kSlot;  // after the two item slots
  const uint32_t bars = ring + kStages * kTile;
  auto full = [&](int t) { return bars + 8 * (t % kStages); };
  auto empty = [&](int t) { return bars + 8 * (kStages + t % kStages); };
  auto q_full = [&](int it) { return bars + 8 * (2 * kStages + (it & 1)); };
  auto q_empty = [&](int it) { return bars + 8 * (2 * kStages + 2 + (it & 1)); };

  const int nk = (Lk + kBwdKC - 1) / kBwdKC;
  const int n_tiles = rows_tile_count<kRecompute, kResident>(nk);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 4 * kBwdConsumers);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * kBwdConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kBwdConsumers) {  // the producer warpgroup: one thread loads every tile
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kBwdConsumers) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tg);
      tma_prefetch_map(&tdq);
      int t = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qb, b = bh / H, h = bh % H;
        const int q0 = (item % n_qb) * kBwdBQ * kBwdConsumers;
        if (it >= 2) mbar_wait(q_empty(it), ((it >> 1) - 1) & 1);
        mbar_expect_tx(q_full(it), kSlot);
        const uint32_t slot = base + (it & 1) * kSlot;
#pragma unroll
        for (int c = 0; c < kBwdConsumers; ++c)
#pragma unroll
          for (int x = 0; x < kHalves; ++x) {
            tma_load_4d(slot + c * kTile + x * 8192, &tq, q_full(it), 64 * x, h, q0 + kBwdBQ * c, b);
            tma_load_4d(slot + (kBwdConsumers + c) * kTile + x * 8192, &tg, q_full(it), 64 * x, h,
                        q0 + kBwdBQ * c, b);
          }
        for (int u = 0; u < n_tiles; ++u, ++t) {
          if (t >= kStages) mbar_wait(empty(t), (t / kStages - 1) & 1);
          bool is_v;
          const int j = rows_tile<kRecompute, kResident>(u, nk, is_v);
          mbar_expect_tx(full(t), kTile);
          const uint32_t dst = ring + (t % kStages) * kTile;
#pragma unroll
          for (int x = 0; x < kHalves; ++x)
            tma_load_4d(dst + x * 8192, is_v ? &tv : &tk, full(t), 64 * x, h, kBwdKC * j, b);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows of each work item, 16 a warp
    regs_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, col0 = 2 * (lane & 3);
    int t = 0;  // the item's first tile in the ring's stream
    auto tile = [&](int u) {
      mbar_wait(full(t + u), ((t + u) / kStages) & 1);
      return ring + ((t + u) % kStages) * kTile;
    };
    auto release = [&](int u) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(t + u));
    };
    // the stored m and s of this thread's rows of an item (zeros past Lq),
    // fetched an item ahead: waited for at its start, they cost a global
    // load's latency an item
    float next_m[2], next_s[2];
    auto fetch_stats = [&](int item) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        next_m[i] = next_s[i] = 0.f;
        const int row = (item % n_qb) * kBwdBQ * kBwdConsumers + kBwdBQ * wg + warp * 16 + g +
                        8 * i;
        if (!kRecompute && item < n_items && row < Lq) {
          const int bh = item / n_qb;
          const size_t at = (static_cast<size_t>(bh / H) * Lq + row) * H + bh % H;
          next_m[i] = m_io[at];
          next_s[i] = s_io[at];
        }
      }
    };
    fetch_stats(blockIdx.x);
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_qb, b = bh / H, h = bh % H;
      const int row_base = (item % n_qb) * kBwdBQ * kBwdConsumers + kBwdBQ * wg;
      const float item_m[2] = {next_m[0], next_m[1]}, item_s[2] = {next_s[0], next_s[1]};
      fetch_stats(item + gridDim.x);
      const uint32_t q_tile = base + (it & 1) * kSlot + wg * kTile;
      const uint32_t g_tile = q_tile + kBwdConsumers * kTile;
      unsigned char* const q_p = base_p + (q_tile - base);
      mbar_wait(q_full(it), (it >> 1) & 1);
      if (row_base >= Lq) {  // a ragged item's spare warpgroup passes the tiles on
        for (int u = 0; u < n_tiles; ++u) {
          tile(u);
          release(u);
        }
      } else {
        const int row0 = row_base + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
        float mx[2], rs[2], sum[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
        if constexpr (kRecompute) {
          mx[0] = mx[1] = -INFINITY;
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = item_m[i];
            rs[i] = item_s[i] > 0.f ? 1.f / item_s[i] : 0.f;
          }
        }
        int u = 0;
        // the resident tiles' logits, then their e (fp32)
        float e[kResident ? kResidentTiles : 1][8][4];
        {  // sweep 1: the logits of the resident tiles, and with kRecompute the row max
          uint32_t qa[D / 16][4];
          scaled_q_rows<D>(qa, q_p, warp, lane, qscale);
          if constexpr (kResident) {
            // one fence, no branch among the products (attention_fwd.cuh)
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < kResidentTiles; ++j) wg_logits_issue<D>(qa, tile(j), e[j]);
#pragma unroll
            for (int j = 0; j < kResidentTiles; ++j) {
              wgmma_wait_static(kResidentTiles - 1 - j);
              fence_regs(e[j]);
              release(j);
              mask_keys(e[j], kBwdKC * j, col0, Lk);
              if constexpr (kRecompute) chunk_row_max(e[j], mx);
            }
            u = kResidentTiles;
          }
          if constexpr (kRecompute) {
            for (int j = R; j < nk; ++j, ++u) {
              float x[8][4];
              wg_logits<D>(qa, tile(u), x);
              release(u);
              mask_keys(x, kBwdKC * j, col0, Lk);
              chunk_row_max(x, mx);
            }
            mx[0] = quad_max(mx[0]);
            mx[1] = quad_max(mx[1]);
          }
        }
        // e and its sums in key order, through the forward's tile_exp_sum
        if constexpr (kResident) {
#pragma unroll
          for (int j = 0; j < kResidentTiles; ++j) tile_exp_sum<FwdMode::kStats>(e[j], mx, sum);
        }
        // sweep 2: dw = do . v^T (both operands from shared memory) and
        // rowsum(dw * e); the tiles past the resident ones take their
        // logits again
#pragma unroll
        for (int j = 0; j < R; ++j, ++u) {
          float w[8][4];
          wg_ss<D>(g_tile, tile(u), w);
          release(u);
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i >> 1] += w[n][i] * e[j][n][i];
        }
        for (int j = R; j < nk; ++j, u += 2) {
          float x[8][4], w[8][4];
          {
            uint32_t qa[D / 16][4];
            scaled_q_rows<D>(qa, q_p, warp, lane, qscale);
            wg_logits<D>(qa, tile(u), x);
          }
          release(u);
          mask_keys(x, kBwdKC * j, col0, Lk);
          tile_exp_sum<FwdMode::kStats>(x, mx, sum);
          wg_ss<D>(g_tile, tile(u + 1), w);
          release(u + 1);
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i >> 1] += w[n][i] * x[n][i];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (kRecompute) {
            sum[i] = quad_sum(sum[i]);
            rs[i] = 1.f / sum[i];
          }
          c[i] = quad_sum(c[i]) * rs[i];
        }
        // sweep 3: dw again, ds0 = bf16(e * (dw - c)) into A fragments, and
        // dq += ds0 . k with the K tile read N-major
        float acc[D / 8][4];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j, u += 2) {
          float w[8][4];
          wg_ss<D>(g_tile, tile(u), w);
          release(u);
          uint32_t da[4][4];
          pack_ds(e[j], w, c, da);
          wg_pv_issue<D>(da, tile(u + 1), acc);
          wgmma_wait<0>();
          fence_regs(acc);
          release(u + 1);
        }
        for (int j = R; j < nk; ++j, u += 2) {
          float x[8][4], w[8][4];
          const uint32_t k_tile = tile(u);
          {
            uint32_t qa[D / 16][4];
            scaled_q_rows<D>(qa, q_p, warp, lane, qscale);
            wg_logits<D>(qa, k_tile, x);
          }
          mask_keys(x, kBwdKC * j, col0, Lk);
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) x[n][i] = exp_centred<FwdMode::kStats>(x[n][i], mx[i >> 1]);
          wg_ss<D>(g_tile, tile(u + 1), w);
          release(u + 1);
          uint32_t da[4][4];
          pack_ds(x, w, c, da);
          wg_pv_issue<D>(da, k_tile, acc);
          wgmma_wait<0>();
          fence_regs(acc);
          release(u);
        }

        // dq * (scale * rs) through the warp's own rows of its Q tile
        const float f[2] = {scale * rs[0], scale * rs[1]};
        store_rows_tma<D>(acc, f, q_p, q_tile, &tdq, h, row_base + warp * 16, b, warp, lane);
        if (lane == 0) bulk_commit();
        // c (and m, s) after the dq store: the proxy fence there would wait on them
        if ((lane & 3) == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (row0 + 8 * i >= Lq) continue;
            const size_t at = (static_cast<size_t>(b) * Lq + row0 + 8 * i) * H + h;
            c_out[at] = c[i];
            if constexpr (kRecompute) {
              m_io[at] = mx[i];
              s_io[at] = sum[i];
            }
          }
        }
      }
      t += n_tiles;
      // the item slot back to the producer, once the dq store has read it
      if (lane == 0) bulk_wait_read();
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(it));
    }
  }
}

// ---- the column pass: dk and dv ---------------------------------------------

// A column-pass work item: 64 * kBwdConsumers keys of one (b, h), a K and a
// V tile a consumer warpgroup, resident while the queries stream past.  A
// stage of the ring holds one 64-row query tile: q (TMA, then bf16(q *
// qscale) in place), do (TMA), bf16(q * scale * rs) and bf16(do * rs), in
// that order; its rows' m, 1 / s and c sit apart, 3 x 64 floats a stage.
template <int D> __host__ __device__ constexpr int cols_kv_slots() { return D > 64 ? 1 : 2; }
template <int D> __host__ __device__ constexpr uint32_t cols_slot_bytes() {
  return 2 * kBwdConsumers * tile_bytes<D>();
}
template <int D> __host__ __device__ constexpr int cols_stages() {
  return static_cast<int>((kBwdTileBytes - cols_kv_slots<D>() * cols_slot_bytes<D>()) /
                          (4 * tile_bytes<D>()));
}
constexpr uint32_t kStatBytes = 3 * kBwdBQ * 4;
template <int D> __host__ __device__ constexpr size_t cols_smem_bytes() {
  return 1024 + kBwdTileBytes + cols_stages<D>() * kStatBytes +
         8 * (3 * cols_stages<D>() + 2 * cols_kv_slots<D>());
}
// the three warps of the producer warpgroup that form the scaled tiles
constexpr int kPrepThreads = 96;

// 8 bf16 values times f, rounded to bf16 (scale_a_rows' arithmetic)
__device__ __forceinline__ uint4 scale_chunk(uint4 x, float f) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = unpack_bf16(w[i]);
    w[i] = pack_bf16(y.x * f, y.y * f);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int D>
__global__ void __launch_bounds__(kFwdWgThreads, 1)
attn_bwd_cols_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, const float* __restrict__ m_in,
                     const float* __restrict__ s_in, const float* __restrict__ c_in, int Lq,
                     int Lk, int H, int n_kb, int n_items, float qscale, float scale) {
  constexpr int kStages = cols_stages<D>();
  constexpr int kSlots = cols_kv_slots<D>();
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr uint32_t kSlot = cols_slot_bytes<D>();
  constexpr uint32_t kStage = 4 * kTile;
  constexpr int kHalves = D > 64 ? 2 : 1;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t base = (smem_addr(bwd_smem) + 1023) & ~1023u;
  unsigned char* const base_p = bwd_smem + (base - smem_addr(bwd_smem));
  const uint32_t ring = base + kSlots * kSlot;
  float* const stats = reinterpret_cast<float*>(base_p + kBwdTileBytes);
  const uint32_t bars = base + kBwdTileBytes + kStages * kStatBytes;
  auto full = [&](int t) { return bars + 8 * (t % kStages); };
  auto prepped = [&](int t) { return bars + 8 * (kStages + t % kStages); };
  auto empty = [&](int t) { return bars + 8 * (2 * kStages + t % kStages); };
  auto kv_full = [&](int it) { return bars + 8 * (3 * kStages + it % kSlots); };
  auto kv_empty = [&](int it) { return bars + 8 * (3 * kStages + kSlots + it % kSlots); };
  auto stage = [&](int t) { return ring + (t % kStages) * kStage; };

  const int nq = (Lq + kBwdBQ - 1) / kBwdBQ;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(prepped(i), kPrepThreads / 32);
      mbar_init(empty(i), 4 * kBwdConsumers);
    }
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), 4 * kBwdConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int lane = threadIdx.x & 31;
  if (wg == kBwdConsumers) {  // the producer warpgroup
    regs_dealloc<kColProducerRegs>();
    const int pw = __shfl_sync(0xffffffffu, (static_cast<int>(threadIdx.x) >> 5) & 3, 0);
    if (pw == 0) {  // one thread loads every tile
      if (lane == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        tma_prefetch_map(&tg);
        tma_prefetch_map(&tdk);
        tma_prefetch_map(&tdv);
        int t = 0;
        for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
          const int bh = item / n_kb, b = bh / H, h = bh % H;
          const int k0 = (item % n_kb) * kBwdKC * kBwdConsumers;
          if (it >= kSlots) mbar_wait(kv_empty(it), (it / kSlots - 1) & 1);
          mbar_expect_tx(kv_full(it), kSlot);
          const uint32_t slot = base + (it % kSlots) * kSlot;
#pragma unroll
          for (int c = 0; c < kBwdConsumers; ++c)
#pragma unroll
            for (int x = 0; x < kHalves; ++x) {
              tma_load_4d(slot + c * kTile + x * 8192, &tk, kv_full(it), 64 * x, h,
                          k0 + kBwdKC * c, b);
              tma_load_4d(slot + (kBwdConsumers + c) * kTile + x * 8192, &tv, kv_full(it), 64 * x,
                          h, k0 + kBwdKC * c, b);
            }
          for (int i = 0; i < nq; ++i, ++t) {
            if (t >= kStages) mbar_wait(empty(t), (t / kStages - 1) & 1);
            mbar_expect_tx(full(t), 2 * kTile);
#pragma unroll
            for (int x = 0; x < kHalves; ++x) {
              tma_load_4d(stage(t) + x * 8192, &tq, full(t), 64 * x, h, kBwdBQ * i, b);
              tma_load_4d(stage(t) + kTile + x * 8192, &tg, full(t), 64 * x, h, kBwdBQ * i, b);
            }
          }
        }
      }
    } else {  // three warps form each stage's scaled tiles and statistics
      const int p = threadIdx.x - 128 * kBwdConsumers - 32;
      // this thread's row p of query tile i of an item: m, s and c, or
      // zeros for a row past Lq (its q and do are zero too)
      auto fetch = [&](int item, int i, float& pm, float& ps, float& pc) {
        pm = ps = pc = 0.f;
        const int row = kBwdBQ * i + p;
        if (item < n_items && p < kBwdBQ && row < Lq) {
          const int bh = item / n_kb;
          const size_t at = (static_cast<size_t>(bh / H) * Lq + row) * H + bh % H;
          pm = m_in[at];
          ps = s_in[at];
          pc = c_in[at];
        }
      };
      float pm, ps, pc;
      fetch(blockIdx.x, 0, pm, ps, pc);
      int t = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        for (int i = 0; i < nq; ++i, ++t) {
          mbar_wait(full(t), (t / kStages) & 1);
          float* const st = stats + (t % kStages) * 3 * kBwdBQ;
          if (p < kBwdBQ) {
            st[p] = pm;
            st[kBwdBQ + p] = ps > 0.f ? 1.f / ps : 0.f;
            st[2 * kBwdBQ + p] = pc;
          }
          named_sync(1, kPrepThreads);
          // the next tile's statistics, in flight while this one is formed
          if (i + 1 < nq)
            fetch(item, i + 1, pm, ps, pc);
          else
            fetch(item + gridDim.x, 0, pm, ps, pc);
          unsigned char* const q_s = base_p + (stage(t) - base);
          constexpr int kChunks = kBwdBQ * D / 8;  // 16-byte chunks a tile
          for (int ch = p; ch < kChunks; ch += kPrepThreads) {
            const int r = ch / (D / 8);
            const uint32_t off = sw_chunk<D>(r, ch % (D / 8));
            const float r_s = st[kBwdBQ + r];
            const uint4 x = *reinterpret_cast<const uint4*>(q_s + off);
            const uint4 y = *reinterpret_cast<const uint4*>(q_s + kTile + off);
            *reinterpret_cast<uint4*>(q_s + 2 * kTile + off) = scale_chunk(x, scale * r_s);
            *reinterpret_cast<uint4*>(q_s + 3 * kTile + off) = scale_chunk(y, r_s);
            *reinterpret_cast<uint4*>(q_s + off) = scale_chunk(x, qscale);
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(prepped(t));
        }
      }
    }
  } else {  // a consumer warpgroup: 64 keys of each work item, 16 a warp
    regs_alloc<kColConsumerRegs>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int col0 = 2 * (lane & 3);
    int t = 0;
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_kb, b = bh / H, h = bh % H;
      const int key_base = (item % n_kb) * kBwdKC * kBwdConsumers + kBwdKC * wg;
      const uint32_t k_tile = base + (it % kSlots) * kSlot + wg * kTile;
      const uint32_t v_tile = k_tile + kBwdConsumers * kTile;
      mbar_wait(kv_full(it), (it / kSlots) & 1);
      if (key_base >= Lk) {  // a ragged item's spare warpgroup passes the stages on
        for (int i = 0; i < nq; ++i) {
          mbar_wait(prepped(t + i), ((t + i) / kStages) & 1);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(t + i));
        }
      } else {
        float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
        // Tile i's logits^T and dw^T are issued right behind tile i - 1's
        // dv and dk products, and one wait takes both.
        for (int i = 0; i < nq; ++i) {
          const int u = t + i;
          mbar_wait(prepped(u), (u / kStages) & 1);
          const uint32_t q_tile = stage(u);
          // logits^T = k . (q * qscale)^T and dw^T = v . do^T, keys as rows
          float s[8][4], w[8][4];
          wgmma_fence();
          wg_ss_issue<D>(k_tile, q_tile, s);
          wg_ss_issue<D>(v_tile, q_tile + kTile, w);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(w);
          fence_regs(dv);
          fence_regs(dk);
          if (i > 0) {  // tile i - 1's stage, read by its products, goes back
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(u - 1));
          }
          // e and ds0 column by column: the thread's query columns 8n + col0, + 1
          const float* const st = stats + (u % kStages) * 3 * kBwdBQ;
          uint32_t pe[4][4], pd[4][4];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 m2 = *reinterpret_cast<const float2*>(st + 8 * n + col0);
            const float2 c2 = *reinterpret_cast<const float2*>(st + 2 * kBwdBQ + 8 * n + col0);
            float e[4], d[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              e[x] = exp_centred<FwdMode::kStats>(s[n][x], (x & 1) ? m2.y : m2.x);
              d[x] = e[x] * (w[n][x] - ((x & 1) ? c2.y : c2.x));
            }
            pe[n >> 1][(n & 1) * 2] = pack_bf16(e[0], e[1]);
            pe[n >> 1][(n & 1) * 2 + 1] = pack_bf16(e[2], e[3]);
            pd[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
            pd[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
          }
          // dv += e^T . bf16(do * rs), dk += ds0^T . bf16(q * scale * rs)
          wgmma_fence();
          wg_pb_issue<D>(pe, q_tile + 3 * kTile, dv);
          wg_pb_issue<D>(pd, q_tile + 2 * kTile, dk);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(t + nq - 1));
        // every warp of the warpgroup is past its products: dk and dv
        // through the warpgroup's own K and V tiles
        named_sync(2 + wg, 128);
        const float one[2] = {1.f, 1.f};
        store_rows_tma<D>(dk, one, base_p + (k_tile - base), k_tile, &tdk, h,
                          key_base + warp * 16, b, warp, lane);
        store_rows_tma<D>(dv, one, base_p + (v_tile - base), v_tile, &tdv, h,
                          key_base + warp * 16, b, warp, lane);
        if (lane == 0) bulk_commit();
      }
      t += nq;
      // the K / V slot back to the producer, once the stores have read it
      if (lane == 0) bulk_wait_read();
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty(it));
    }
  }
}

// ---- launch ----------------------------------------------------------------

// TMA and the 16-byte stores need 16-byte aligned rows: base addresses and
// batch and row strides that are multiples of 8 bf16 elements (a stride of
// a size-1 dimension is never used)
bool bwd_tma_operands_ok(const void* q, const void* k, const void* v, const void* g,
                         const void* dq, const void* dk, const void* dv, int B, int Lq, int Lk,
                         const Strides& st) {
  for (const void* p : {q, k, v, g, dq, dk, dv})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (long long s : {st.qb, st.kb, st.vb, st.gb, st.dqb, st.dkb, st.dvb})
    if (B > 1 && s % 8 != 0) return false;
  for (long long s : {st.qr, st.gr, st.dqr})
    if (Lq > 1 && s % 8 != 0) return false;
  for (long long s : {st.kr, st.vr, st.dkr, st.dvr})
    if (Lk > 1 && s % 8 != 0) return false;
  return true;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct BwdMaps {
  CUtensorMap q, k, v, g, dq, dk, dv;
};

template <int D, bool kRecompute, bool kResident>
cudaError_t rows_launch(const BwdMaps& mp, float* m, float* s, float* c, int B, int Lq, int Lk,
                        int H, int sms, float qscale, float scale, cudaStream_t stream) {
  auto kernel = attn_bwd_rows_kernel<D, kRecompute, kResident>;
  static const cudaError_t budget = check_reg_budget(kernel, kProducerRegs, kConsumerRegs);
  if (budget != cudaSuccess) return budget;
  constexpr size_t smem = rows_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_qb = (Lq + kBwdBQ * kBwdConsumers - 1) / (kBwdBQ * kBwdConsumers);
  const long long n_items = static_cast<long long>(n_qb) * B * H;
  const int blocks = static_cast<int>(std::min<long long>(n_items, sms));
  kernel<<<blocks, kFwdWgThreads, smem, stream>>>(mp.q, mp.k, mp.v, mp.g, mp.dq, m, s, c, Lq, Lk,
                                                  H, n_qb, static_cast<int>(n_items), qscale,
                                                  scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t cols_launch(const BwdMaps& mp, const float* m, const float* s, const float* c, int B,
                        int Lq, int Lk, int H, int sms, float qscale, float scale,
                        cudaStream_t stream) {
  auto kernel = attn_bwd_cols_kernel<D>;
  static const cudaError_t budget = check_reg_budget(kernel, kColProducerRegs, kColConsumerRegs);
  if (budget != cudaSuccess) return budget;
  constexpr size_t smem = cols_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_kb = (Lk + kBwdKC * kBwdConsumers - 1) / (kBwdKC * kBwdConsumers);
  const long long n_items = static_cast<long long>(n_kb) * B * H;
  const int blocks = static_cast<int>(std::min<long long>(n_items, sms));
  kernel<<<blocks, kFwdWgThreads, smem, stream>>>(mp.q, mp.k, mp.v, mp.g, mp.dk, mp.dv, m, s, c,
                                                  Lq, Lk, H, n_kb, static_cast<int>(n_items),
                                                  qscale, scale);
  return cudaGetLastError();
}

// the bf16 body: the row pass, then the column pass, which reads its c (and
// with kRecompute its m and s)
template <int D, bool kRecompute>
cudaError_t bwd_wgmma_launch(const void* q, const void* k, const void* v, const void* g,
                             float* m, float* s, void* dq, void* dk, void* dv, float* c, int B,
                             int Lq, int Lk, int H, const Strides& st, float qscale, float scale,
                             cudaStream_t stream) {
  // operands read in 64-row boxes, gradients stored 16 rows (a warp's) a box
  BwdMaps mp;
  if (!make_head_map(&mp.q, q, D, H, Lq, B, st.qr, st.qb, kBwdBQ) ||
      !make_head_map(&mp.g, g, D, H, Lq, B, st.gr, st.gb, kBwdBQ) ||
      !make_head_map(&mp.k, k, D, H, Lk, B, st.kr, st.kb, kBwdKC) ||
      !make_head_map(&mp.v, v, D, H, Lk, B, st.vr, st.vb, kBwdKC) ||
      !make_head_map(&mp.dq, dq, D, H, Lq, B, st.dqr, st.dqb, 16) ||
      !make_head_map(&mp.dk, dk, D, H, Lk, B, st.dkr, st.dkb, 16) ||
      !make_head_map(&mp.dv, dv, D, H, Lk, B, st.dvr, st.dvb, 16))
    return cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  // the logits of four key tiles stay in registers when there are four or
  // more (D = 128's accumulators leave no room)
  if (D <= 64 && Lk > (kResidentTiles - 1) * kBwdKC)
    err = rows_launch<D, kRecompute, D <= 64>(mp, m, s, c, B, Lq, Lk, H, sms, qscale, scale,
                                              stream);
  else
    err = rows_launch<D, kRecompute, false>(mp, m, s, c, B, Lq, Lk, H, sms, qscale, scale,
                                            stream);
  if (err != cudaSuccess) return err;
  return cols_launch<D>(mp, m, s, c, B, Lq, Lk, H, sms, qscale, scale, stream);
}

template <typename T, int D, bool kRecompute>
cudaError_t bwd_launch(const void* q, const void* k, const void* v, const void* g,
                       float* m, float* s, void* dq, void* dk, void* dv, float* c, int B,
                       int Lq, int Lk, int H, const Strides& st, float qscale, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (!bwd_tma_operands_ok(q, k, v, g, dq, dk, dv, B, Lq, Lk, st))
      return cudaErrorMisalignedAddress;
    return bwd_wgmma_launch<D, kRecompute>(q, k, v, g, m, s, dq, dk, dv, c, B, Lq, Lk, H, st,
                                           qscale, scale, stream);
  } else {
    const T* qp = static_cast<const T*>(q);
    const T* kp = static_cast<const T*>(k);
    const T* vp = static_cast<const T*>(v);
    const T* gp = static_cast<const T*>(g);
    const int n_qb = (Lq + kBwdBQ - 1) / kBwdBQ, n_kb = (Lk + kBwdKC - 1) / kBwdKC;
    const size_t smem1 = dq_smem_bytes(D, Lk), smem2 = dkdv_smem_bytes(D);
    cudaError_t err;
    auto k1 = attn_bwd_dq_kernel<D, kRecompute>;
    if ((err = allow_smem(k1, smem1)) != cudaSuccess) return err;
    k1<<<dim3(B * H, n_qb), kBwdThreads, smem1, stream>>>(
        qp, kp, vp, gp, m, s, static_cast<T*>(dq), c, Lq, Lk, H, st, qscale, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto k2 = attn_bwd_dkdv_kernel<D>;
    if ((err = allow_smem(k2, smem2)) != cudaSuccess) return err;
    k2<<<dim3(B * H, n_kb), kBwdThreads, smem2, stream>>>(
        qp, kp, vp, gp, m, s, c, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, st,
        qscale, scale);
    return cudaGetLastError();
  }
}

template <bool kRecompute>
cudaError_t bwd_dispatch(int dtype, int head_dim, const void* q, const void* k,
                         const void* v, const void* g, float* m, float* s, void* dq,
                         void* dk, void* dv, float* c, int B, int Lq, int Lk, int H,
                         const Strides& st, float qscale, float scale, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return cudaErrorInvalidValue;
  const long long n_qb = (Lq + kBwdBQ - 1) / kBwdBQ, n_kb = (Lk + kBwdKC - 1) / kBwdKC;
  // the fp32 body's 2-D grids and the bf16 body's 1-D grids
  if (n_qb > 65535 || n_kb > 65535 || (n_qb > n_kb ? n_qb : n_kb) * B * H > INT_MAX)
    return cudaErrorInvalidValue;
  // the fp32 body's tiles set the Lk limit of both dtypes, as the wrapper checks it
  if (dq_smem_bytes(head_dim, Lk) > 232448 || dkdv_smem_bytes(head_dim) > 232448)
    return cudaErrorInvalidValue;
#define DIG_BWD_CASE(T, D) \
  return bwd_launch<T, D, kRecompute>(q, k, v, g, m, s, dq, dk, dv, c, B, Lq, Lk, H, st, qscale, scale, stream)
  if (dtype == 0) {
    switch (head_dim) {
      case 32: DIG_BWD_CASE(float, 32);
      case 64: DIG_BWD_CASE(float, 64);
      case 128: DIG_BWD_CASE(float, 128);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 32: DIG_BWD_CASE(bf16, 32);
      case 64: DIG_BWD_CASE(bf16, 64);
      case 128: DIG_BWD_CASE(bf16, 128);
    }
  }
#undef DIG_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
