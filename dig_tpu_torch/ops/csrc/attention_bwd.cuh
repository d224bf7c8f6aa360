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
//  1. dq pass, one CTA per (b, h, 64 query rows) against all Lk keys: dq,
//     and c into a small fp32 [B, Lq, H] scratch for the second pass.  With
//     kRecompute it first takes m and s itself, in the forward kernel's
//     order, and writes them beside c; otherwise it reads the forward's.
//  2. dk/dv pass, one CTA per (b, h, 64 keys) that walks the queries in
//     64-row chunks, forms the 64 x 64 tiles of e and ds0 again from m, s
//     and c, and sums dk and dv in registers.
// q, k, v, do and the three gradients are addressed through batch and row
// strides, so column slices of the packed qkv [B, L, 3*H*D] and of its
// gradient are read and written in place.
//
// What bounds it on an H100: bytes.  At the pre-training shapes (B = 256,
// L = 256, H = 6, D = 64, bf16) the function moves 355 MB (q, k, v, do read,
// dq, dk, dv written, m and s read), 0.106 ms at 3.35 TB/s, against 5
// products of 2*B*H*L*L*D (64 GFLOP, 0.065 ms on the bf16 tensor cores).
//
// bf16: attn_bwd_dq_mma_kernel and attn_bwd_dkdv_mma_kernel, one warpgroup
// (4 warps) a block, built from the forward's pieces (attention_fwd.cuh):
//  * every product on the tensor cores (mma.sync m16n8k16, bf16 operands
//    from ldmatrix, fp32 accumulators); operands stay bf16 and move by
//    16-byte cp.async into tiles padded 16 bytes a row, through a ring, so
//    copies overlap products;
//  * the logits come from chunk_logits with q scaled by scale_a_rows, the
//    forward's own functions with q as the A operand and K as stored in both
//    passes: they are the forward's logits bit for bit, so m is their exact
//    max (e <= 1), and kRecompute, which takes m with the forward's sweep
//    and s in the forward's order, gives the stored-statistics results bit
//    for bit.  dw = do . v^T is the same function on the dO and V tiles;
//  * no score tile in the dq pass: a warp keeps 16 query rows' q and do as
//    A fragments and sweeps the keys twice.  Sweep 1 takes each chunk's
//    logits and dw and keeps only the rows' running rowsum(dw * e) (and s);
//    sweep 2 computes the same bits again, forms ds0 = bf16(e * (dw - c))
//    straight into A fragments and sums dq = ds0 . k with K through
//    ldmatrix.trans.  That is 5 products where a kept tile needs 3, for
//    shared memory that does not grow with Lk (54 KB at D = 64).  Both
//    sweeps go by 32 keys, so half a chunk's accumulators are live at once;
//  * the dk/dv pass keeps its K and V tiles resident and dk and dv in
//    registers (16 keys x D a warp, twice).  A warp computes its 16 query
//    rows' e and ds0 against the 64 keys, with the forward's operand roles,
//    and writes them as bf16 into two 64 x 64 tiles; after a barrier every
//    warp reads its 16 keys' columns of them back transposed
//    (ldmatrix.trans) as the A fragments of e^T . (do * rs) and
//    ds0^T . (q * scale * rs).  Those scaled operands are formed in place:
//    a warp reads only its own 16 rows of the Q and dO tiles as A
//    fragments, so it overwrites them with the scaled, rounded rows, which
//    all warps then read as B operands.  q and do move once a chunk, two
//    barriers a chunk; the logits and dw go by 16 keys, which keeps the pass
//    within 168 registers without spills (72 KB at D = 64);
//  * 1-D grids with the query block (dq pass) or key block (dk/dv pass)
//    fastest, so the blocks of one (b, h) run side by side and share K, V
//    or Q, dO through L2.
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
constexpr int kBwdBQ = 64;  // query rows per CTA (dq pass) / per chunk (dk/dv pass)
constexpr int kBwdKC = 64;  // keys per chunk (dq pass) / per CTA (dk/dv pass)

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

// ---- bf16: the tensor-core body ----------------------------------------

static_assert(kBwdBQ == kFwdBQ && kBwdKC == kFwdKC, "the forward's tiles");

// K / V tiles in the dq pass's ring.  The pass holds a chunk's K tile while
// it asks for the V tile, so a refill goes to the stage of the tile before
// the last: kBwdStages - 2 tiles are in flight.  On the H100 rings of 4, 5
// and 6 stages took the same time.  Both passes run three blocks an SM
// (168 registers at D = 64): two blocks with every value in registers were
// 15-20 % slower, four blocks of the dq pass at 128 registers no faster.
constexpr int kBwdStages = 4;
// row stride, in elements, of the dk/dv pass's 64 x 64 tiles of e and ds0:
// 16 bytes of padding, as mma_ld
constexpr int kLdP = kBwdBQ + 8;

template <int D> __host__ __device__ constexpr size_t dq_mma_smem_bytes() {
  return sizeof(bf16) * (2 + kBwdStages) * kBwdBQ * mma_ld<D>();  // Q, dO tiles + ring
}

template <int D> __host__ __device__ constexpr size_t dkdv_mma_smem_bytes() {
  // K, V tiles, two (Q, dO) stages, the e and ds0 tiles
  return sizeof(bf16) * (6 * kBwdBQ * mma_ld<D>() + 2 * kBwdBQ * kLdP);
}

// A warp's 16 x D fp32 accumulators times f[0] (row g) and f[1] (row g + 8),
// rounded to bf16 into the warp's 16 rows of a padded tile (stage), then
// written as whole rows by 16-byte stores to dst (row stride rs elements),
// for the rows row0 + r < L.  stage is the warp's own: no block barrier.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], const float (&f)[2],
                                           bf16* stage, bf16* dst, long long rs, int row0,
                                           int L, int lane) {
  constexpr int kLd = mma_ld<D>();
  const int g = lane >> 2, col0 = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * kLd + n * 8 + col0) =
        __floats2bfloat162_rn(acc[n][0] * f[0], acc[n][1] * f[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kLd + n * 8 + col0) =
        __floats2bfloat162_rn(acc[n][2] * f[1], acc[n][3] * f[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c / kChunks, p = c % kChunks;
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * rs + p * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + p * 8);
  }
}

// Pass 1: dq and c for 64 query rows of one (b, h), 16 rows a warp.  m and
// s are read (stored statistics) or taken and written (kRecompute).
template <int D, bool kRecompute>
__global__ void __launch_bounds__(kMmaThreads, D >= 128 ? 2 : 3)
attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       float* __restrict__ m_io, float* __restrict__ s_io,
                       bf16* __restrict__ dq, float* __restrict__ c_out, int Lq, int Lk,
                       int H, int n_qb, Strides st, float qscale, float scale) {
  constexpr int kTile = kBwdBQ * mma_ld<D>();  // elements of one 64-row tile
  constexpr int kHalf = 32 * mma_ld<D>() * 2;  // bytes of 32 rows: the sweeps go by 32 keys
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(bwd_smem);  // Q tile, later dq
  bf16* g_s = q_s + kTile;                        // dO tile
  bf16* ring = g_s + kTile;                       // kBwdStages K / V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (blockIdx.x % n_qb) * kBwdBQ;
  const bf16* kg = k + b * st.kb + h * D;
  const bf16* vg = v + b * st.vb + h * D;

  // the tile stream: with kRecompute K chunks 0..nk-1 (the max sweep); then
  // K0, V0, K1, V1, ... twice (sweeps 1 and 2)
  const int nk = (Lk + kBwdKC - 1) / kBwdKC;
  const int n_pre = kRecompute ? nk : 0;
  const int n_tiles = n_pre + 4 * nk;
  auto load_tile = [&](int t) {
    bf16* dst = ring + (t % kBwdStages) * kTile;
    int j = t < n_pre ? t : (t - n_pre) >> 1;
    if (j >= nk) j -= nk;
    if (t >= n_pre && ((t - n_pre) & 1))
      load_rows<D>(dst, vg, st.vr, j * kBwdKC, Lk, tid);
    else
      load_rows<D>(dst, kg, st.kr, j * kBwdKC, Lk, tid);
  };
  load_rows<D>(q_s, q + b * st.qb + h * D, st.qr, q0, Lq, tid);
  load_rows<D>(g_s, g + b * st.gb + h * D, st.gr, q0, Lq, tid);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < kBwdStages - 2; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  // waits for the next tile, refills the stage of the tile before the last
  // (every warp has finished with it), and returns the tile's address
  int t_next = 0;
  auto next_tile = [&]() -> uint32_t {
    cp_async_wait<kBwdStages - 3>();
    __syncthreads();
    const int t = t_next++;
    if (t + kBwdStages - 2 < n_tiles) load_tile(t + kBwdStages - 2);
    cp_async_commit();
    return smem_addr(ring + (t % kBwdStages) * kTile);
  };

  cp_async_wait<kBwdStages - 2>();  // Q and dO
  __syncthreads();
  // the warp's 16 rows of q, scaled as the forward scales them, and of do,
  // kept as A fragments for every sweep
  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a_rows<D>(qa, smem_addr(q_s), warp, lane);
  scale_a_rows<D>(qa, qscale);
  load_a_rows<D>(ga, smem_addr(g_s), warp, lane);

  const int col0 = 2 * (lane & 3);
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0 and row0 + 8
  float mx[2], rs[2];
  if constexpr (kRecompute) {
    mx[0] = mx[1] = -INFINITY;
    for (int j = 0; j < nk; ++j) {  // the forward's sweep 1: the row max
      float s[8][4];
      chunk_logits<D>(qa, next_tile(), lane, s);
      mask_keys(s, j * kBwdKC, col0, Lk);
      chunk_row_max(s, mx);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row0 + 8 * i < Lq;
      const size_t at = (static_cast<size_t>(b) * Lq + row0 + 8 * i) * H + h;
      mx[i] = ok ? m_io[at] : 0.f;
      rs[i] = ok ? 1.f / s_io[at] : 0.f;
    }
  }

  // sweep 1: rowsum(dw * e), and with kRecompute s, per-thread partials in
  // key order and then over the quad, as the forward sums s.  32 keys at a
  // time: half the accumulators of a whole chunk live at once.
  float sum[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  for (int j = 0; j < nk; ++j) {
    const uint32_t k_tile = next_tile();
    const uint32_t v_tile = next_tile();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s[4][4], w[4][4];
      chunk_logits<D, 2>(qa, k_tile + hf * kHalf, lane, s);
      mask_keys(s, j * kBwdKC + hf * 32, col0, Lk);
      chunk_logits<D, 2>(ga, v_tile + hf * kHalf, lane, w);  // dw: V rows past Lk are zeros
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = exp2f(s[n][i] - mx[i >> 1]);
          if constexpr (kRecompute) sum[i >> 1] += e;
          c[i >> 1] += w[n][i] * e;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (kRecompute) {
      sum[i] = quad_sum(sum[i]);
      rs[i] = 1.f / sum[i];
    }
    c[i] = quad_sum(c[i]) * rs[i];
  }

  // sweep 2: the same logits and dw again, ds0 into A fragments, dq
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const uint32_t k_tile = next_tile();
    const uint32_t v_tile = next_tile();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s[4][4], w[4][4];
      chunk_logits<D, 2>(qa, k_tile + hf * kHalf, lane, s);
      mask_keys(s, j * kBwdKC + hf * 32, col0, Lk);
      chunk_logits<D, 2>(ga, v_tile + hf * kHalf, lane, w);
      uint32_t da[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float ds[4];  // a key past Lk: e = 0, so ds0 = 0
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[i] = exp2f(s[n][i] - mx[i >> 1]) * (w[n][i] - c[i >> 1]);
        da[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);      // row g
        da[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);  // row g + 8
      }
      chunk_pv<D, 2>(da, k_tile + hf * kHalf, lane, acc);
    }
  }

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
  // dq * (scale * rs) through the warp's own rows of the Q tile
  const float f[2] = {scale * rs[0], scale * rs[1]};
  store_rows<D>(acc, f, q_s + warp * 16 * mma_ld<D>(), dq + b * st.dqb + h * D, st.dqr,
                q0 + warp * 16, Lq, lane);
}

// a * f[0] (rows g: a[.][0], a[.][2]) and a * f[1] (rows g + 8), rounded to
// bf16 and written back over the warp's 16 rows of the tile the fragments
// came from (load_a_rows)
template <int D>
__device__ __forceinline__ void store_scaled_a_rows(const uint32_t (&a)[D / 16][4],
                                                    const float (&f)[2], bf16* tile, int warp,
                                                    int lane) {
  bf16* row = tile + (warp * 16 + (lane >> 2)) * mma_ld<D>() + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack_bf16(a[kk][i]);
      *reinterpret_cast<uint32_t*>(row + (i & 1) * 8 * mma_ld<D>() + kk * 16 + (i >> 1) * 8) =
          pack_bf16(x.x * f[i & 1], x.y * f[i & 1]);
    }
}

// The A fragments of a warp's 16 keys (16 * warp ... + 15) of the transpose
// of a [64 queries][64 keys] tile (row stride kLdP): a[kb] covers queries
// 16 * kb ... + 15.  Matrices in A's order: (keys 0-7, queries 0-7), (keys
// 8-15, queries 0-7), (keys 0-7, queries 8-15), (keys 8-15, queries 8-15),
// each an 8 x 8 block of the tile read transposed.
__device__ __forceinline__ void load_at_rows(uint32_t (&a)[4][4], uint32_t tile, int warp,
                                             int lane) {
  const uint32_t base =
      tile + (((lane & 7) + ((lane >> 4) << 3)) * kLdP + warp * 16 + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) ldmatrix_x4_trans(a[kb], base + kb * 16 * kLdP * 2);
}

// Pass 2: dk and dv for 64 keys of one (b, h), 16 keys a warp, summed over
// all queries.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D >= 128 ? 1 : 3)
attn_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ m_in, const float* __restrict__ s_in,
                         const float* __restrict__ c_in, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Lq, int Lk, int H, int n_kb, Strides st,
                         float qscale, float scale) {
  constexpr int kTile = kBwdBQ * mma_ld<D>();
  constexpr int kQuarter = 16 * mma_ld<D>() * 2;  // bytes of 16 rows
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(bwd_smem);  // this block's keys, later dk
  bf16* v_s = k_s + kTile;                        // this block's values, later dv
  bf16* ring = v_s + kTile;                       // two stages of (Q tile, dO tile)
  bf16* p_s = ring + 4 * kTile;                   // e in v's dtype [64 queries][kLdP]
  bf16* d_s = p_s + kBwdBQ * kLdP;                // ds0 [64 queries][kLdP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / n_kb;
  const int b = bh / H;
  const int h = bh % H;
  const int j0 = (blockIdx.x % n_kb) * kBwdKC;
  const bf16* qg = q + b * st.qb + h * D;
  const bf16* gg = g + b * st.gb + h * D;

  auto load_pair = [&](int i) {
    bf16* dst = ring + (i & 1) * 2 * kTile;
    load_rows<D>(dst, qg, st.qr, i * kBwdBQ, Lq, tid);
    load_rows<D>(dst + kTile, gg, st.gr, i * kBwdBQ, Lq, tid);
  };
  load_rows<D>(k_s, k + b * st.kb + h * D, st.kr, j0, Lk, tid);
  load_rows<D>(v_s, v + b * st.vb + h * D, st.vr, j0, Lk, tid);
  load_pair(0);
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  const int g8 = lane >> 2, col0 = 2 * (lane & 3);
  const int nq = (Lq + kBwdBQ - 1) / kBwdBQ;
  for (int i = 0; i < nq; ++i) {
    // this thread's query rows of the chunk: row0 and row0 + 8.  A row past
    // Lq has zero q and do tiles and m = c = rs = 0: e = 1 meets do * rs = 0
    // and ds0 = 1 * (0 - 0) = 0, so it adds nothing to dk and dv.
    const int row0 = i * kBwdBQ + warp * 16 + g8;
    float mx[2], rs[2], c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row0 + 8 * r < Lq;
      const size_t at = (static_cast<size_t>(b) * Lq + row0 + 8 * r) * H + h;
      mx[r] = ok ? m_in[at] : 0.f;
      rs[r] = ok ? 1.f / s_in[at] : 0.f;
      c[r] = ok ? c_in[at] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();  // chunk i has arrived; every warp is done with chunk i - 1
    if (i + 1 < nq) load_pair(i + 1);
    cp_async_commit();
    bf16* q_t = ring + (i & 1) * 2 * kTile;
    bf16* g_t = q_t + kTile;

    // logits and dw of the warp's 16 query rows against the block's 64
    // keys, with the forward's operand roles; the rows of the Q and dO
    // tiles, which only this warp reads as A fragments, become
    // q * (scale * rs) and do * rs in bf16, the B operands of dk and dv
    uint32_t qa[D / 16][4], ga[D / 16][4];
    load_a_rows<D>(qa, smem_addr(q_t), warp, lane);
    load_a_rows<D>(ga, smem_addr(g_t), warp, lane);
    __syncwarp();
    const float f[2] = {scale * rs[0], scale * rs[1]};
    store_scaled_a_rows<D>(qa, f, q_t, warp, lane);
    store_scaled_a_rows<D>(ga, rs, g_t, warp, lane);
    scale_a_rows<D>(qa, qscale);
    bf16* p_row = p_s + (warp * 16 + g8) * kLdP + col0;
    bf16* d_row = d_s + (warp * 16 + g8) * kLdP + col0;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {  // 16 keys at a time: few accumulators live
      float s[2][4], w[2][4];
      chunk_logits<D, 1>(qa, smem_addr(k_s) + kq * kQuarter, lane, s);
      mask_keys(s, j0 + kq * 16, col0, Lk);
      chunk_logits<D, 1>(ga, smem_addr(v_s) + kq * kQuarter, lane, w);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float e[4], ds[4];  // a key past Lk: e = 0 and ds0 = 0
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          e[x] = exp2f(s[n][x] - mx[x >> 1]);
          ds[x] = e[x] * (w[n][x] - c[x >> 1]);
        }
        const int col = (2 * kq + n) * 8;
        *reinterpret_cast<uint32_t*>(p_row + col) = pack_bf16(e[0], e[1]);
        *reinterpret_cast<uint32_t*>(p_row + 8 * kLdP + col) = pack_bf16(e[2], e[3]);
        *reinterpret_cast<uint32_t*>(d_row + col) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(d_row + 8 * kLdP + col) = pack_bf16(ds[2], ds[3]);
      }
    }
    __syncthreads();  // the e and ds0 tiles and the scaled rows are whole

    // dv += e^T . (do * rs), dk += ds0^T . (q * scale * rs): the warp's 16 keys
    uint32_t a[4][4];
    load_at_rows(a, smem_addr(p_s), warp, lane);
    chunk_pv<D>(a, smem_addr(g_t), lane, acc_v);
    load_at_rows(a, smem_addr(d_s), warp, lane);
    chunk_pv<D>(a, smem_addr(q_t), lane, acc_k);
  }

  // every warp is past the last chunk's logits: the K and V tiles are free
  const float one[2] = {1.f, 1.f};
  store_rows<D>(acc_k, one, k_s + warp * 16 * mma_ld<D>(), dk + b * st.dkb + h * D, st.dkr,
                j0 + warp * 16, Lk, lane);
  store_rows<D>(acc_v, one, v_s + warp * 16 * mma_ld<D>(), dv + b * st.dvb + h * D, st.dvr,
                j0 + warp * 16, Lk, lane);
}

// ---- launch ----------------------------------------------------------------

// 16-byte copies and stores need 16-byte aligned rows: base addresses and
// batch and row strides that are multiples of 8 bf16 elements (a stride of
// a size-1 dimension is never used)
bool bwd_mma_operands_ok(const void* q, const void* k, const void* v, const void* g,
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

template <typename T, int D, bool kRecompute>
cudaError_t bwd_launch(const void* q, const void* k, const void* v, const void* g,
                       float* m, float* s, void* dq, void* dk, void* dv, float* c, int B,
                       int Lq, int Lk, int H, const Strides& st, float qscale, float scale,
                       cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const int n_qb = (Lq + kBwdBQ - 1) / kBwdBQ, n_kb = (Lk + kBwdKC - 1) / kBwdKC;
  cudaError_t err;

  if constexpr (std::is_same<T, bf16>::value) {
    if (!bwd_mma_operands_ok(q, k, v, g, dq, dk, dv, B, Lq, Lk, st))
      return cudaErrorMisalignedAddress;
    // 1-D grids, the blocks of one (b, h) side by side
    auto k1 = attn_bwd_dq_mma_kernel<D, kRecompute>;
    if ((err = allow_smem(k1, dq_mma_smem_bytes<D>())) != cudaSuccess) return err;
    k1<<<static_cast<unsigned>(n_qb) * B * H, kMmaThreads, dq_mma_smem_bytes<D>(), stream>>>(
        qp, kp, vp, gp, m, s, static_cast<T*>(dq), c, Lq, Lk, H, n_qb, st, qscale, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto k2 = attn_bwd_dkdv_mma_kernel<D>;
    if ((err = allow_smem(k2, dkdv_mma_smem_bytes<D>())) != cudaSuccess) return err;
    k2<<<static_cast<unsigned>(n_kb) * B * H, kMmaThreads, dkdv_mma_smem_bytes<D>(), stream>>>(
        qp, kp, vp, gp, m, s, c, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, n_kb, st,
        qscale, scale);
  } else {
    const size_t smem1 = dq_smem_bytes(D, Lk), smem2 = dkdv_smem_bytes(D);
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
  }
  return cudaGetLastError();
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
