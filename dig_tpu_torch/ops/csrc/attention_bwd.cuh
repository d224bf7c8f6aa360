// The multi-head attention backward kernels shared by attention_lse_bwd.cu
// (from the forward's stored row statistics) and attention_bwd.cu (which
// recomputes them).  For each (batch b, head h), with m and s the fp32 row
// max and exp2-sum of the logits:
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
// Design.  The TPU kernels hold one head's whole 256 x 256 fp32 score tile
// in VMEM and sum dk, dv over the query rows and dq over the keys in one
// body.  A Hopper CTA has 227 KB, so the two reductions are split over two
// launches, as in FlashAttention-2, and neither uses atomics (the result
// does not change from run to run):
//  1. dq pass, one CTA per (b, h, 64 query rows) against all Lk keys.  The
//     64 x Lk tiles e and dw stay in shared memory (2 x 64 KB at Lk = 256),
//     so c is exact in one pass; ds0 overwrites e, and dq = ds0 . k is
//     summed over 64-key chunks.  c is written to a small fp32 [B, Lq, H]
//     scratch for the second pass.  With kRecompute the pass first takes
//     m and s from the whole logit row it holds, in the forward kernel's
//     order (attention_fwd.cuh), and writes them to scratch beside c;
//     otherwise it reads the forward's m and s.
//  2. dk/dv pass, one CTA per (b, h, 64 keys) that walks all queries in
//     64-row chunks, recomputes the 64 x 64 tiles of e and dw from m, s and
//     c, and sums dk and dv in registers.
// The logits and dw are summed in the same order (ascending D, fmaf) in
// both passes and in the forward kernel, so they are bitwise the same
// numbers everywhere and m, s and c belong to them: the recomputing
// backward gives bitwise the results of the stored-statistics one.  q, k,
// v, do and the three gradients are addressed through batch and row
// strides, so column slices of the packed qkv [B, L, 3*H*D] and of its
// gradient are read and written in place.
#pragma once

#include <math.h>

#include "common.cuh"

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

// Pass 1: dq and c for kBQ query rows of one (b, h).  m and s are read
// (stored statistics) or written (kRecompute).
template <typename T, int D, bool kRecompute>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   float* __restrict__ m_io, float* __restrict__ s_io,
                   T* __restrict__ dq, float* __restrict__ c_out, int Lq, int Lk,
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
  const T* qb = q + b * st.qb + h * D;
  const T* kb = k + b * st.kb + h * D;
  const T* vb = v + b * st.vb + h * D;
  const T* gb = g + b * st.gb + h * D;

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
    if (q0 + r < Lq) val = round_t<T>(to_f(qb[(q0 + r) * st.qr + d]) * qscale);
    a_s[r * (D + 1) + d] = val;
  }

  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  // e = exp2(logits - m) (or, with kRecompute, the logits), one 64-key chunk at a time
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[d * (kKC + 1) + j] = (k0 + j < Lk) ? to_f(kb[(k0 + j) * st.kr + d]) : 0.f;
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

  // a_s = do (already in v's dtype: one T for all operands)
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    a_s[r * (D + 1) + d] = (q0 + r < Lq) ? to_f(gb[(q0 + r) * st.gr + d]) : 0.f;
  }

  // dw = do . v^T, one 64-key chunk at a time
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[d * (kKC + 1) + j] = (k0 + j < Lk) ? to_f(vb[(k0 + j) * st.vr + d]) : 0.f;
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
    for (int col = lane; col < Lk; col += 32) er[col] = round_t<T>(er[col] * (wr[col] - c));
    if (lane == 0 && q0 + r < Lq) c_out[(static_cast<size_t>(b) * Lq + q0 + r) * H + h] = c;
  }

  // dq = ds0 . k * (scale * rs), one 64-key chunk of K at a time
  constexpr int NC = D / 16;
  float acc[4][NC] = {};
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[j * D + d] = (k0 + j < Lk) ? to_f(kb[(k0 + j) * st.kr + d]) : 0.f;
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
    T* row = dq + b * st.dqb + (q0 + r) * st.dqr + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c] * f);
  }
}

// Pass 2: dk and dv for kKC keys of one (b, h), summed over all queries.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ m_in, const float* __restrict__ s_in,
                     const float* __restrict__ c_in, T* __restrict__ dk,
                     T* __restrict__ dv, int Lq, int Lk, int H, Strides st,
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
  const T* qb = q + b * st.qb + h * D;
  const T* kb = k + b * st.kb + h * D;
  const T* vb = v + b * st.vb + h * D;
  const T* gb = g + b * st.gb + h * D;

  for (int idx = tid; idx < kKC * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    const bool ok = j0 + j < Lk;
    k_s[j * (D + 1) + d] = ok ? to_f(kb[(j0 + j) * st.kr + d]) : 0.f;
    v_s[j * (D + 1) + d] = ok ? to_f(vb[(j0 + j) * st.vr + d]) : 0.f;
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
      a_s[d * ldq + i] = ok ? round_t<T>(to_f(qb[(i0 + i) * st.qr + d]) * qscale) : 0.f;
      o_s[d * ldq + i] = ok ? to_f(gb[(i0 + i) * st.gr + d]) : 0.f;
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
        p_s[j * ldq + i] = ok ? round_t<T>(e) : 0.f;
        g_s[j * ldq + i] = ok ? round_t<T>(e * (wacc[jj][ii] - c_s[i])) : 0.f;
      }
    __syncthreads();

    // the right-hand operands, row-major, in the input's precision
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      const bool ok = i0 + i < Lq;
      const float rs = rs_s[i];
      a_s[i * D + d] = ok ? round_t<T>(to_f(qb[(i0 + i) * st.qr + d]) * (scale * rs)) : 0.f;
      o_s[i * D + d] = ok ? round_t<T>(to_f(gb[(i0 + i) * st.gr + d]) * rs) : 0.f;
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
    T* krow = dk + b * st.dkb + (j0 + j) * st.dkr + h * D;
    T* vrow = dv + b * st.dvb + (j0 + j) * st.dvr + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      krow[tx + 16 * c] = from_f<T>(acc_dk[jj][c]);
      vrow[tx + 16 * c] = from_f<T>(acc_dv[jj][c]);
    }
  }
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

  const size_t smem1 = dq_smem_bytes(D, Lk);
  auto k1 = attn_bwd_dq_kernel<T, D, kRecompute>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  k1<<<dim3(B * H, (Lq + kBwdBQ - 1) / kBwdBQ), kBwdThreads, smem1, stream>>>(
      qp, kp, vp, gp, m, s, static_cast<T*>(dq), c, Lq, Lk, H, st, qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 = dkdv_smem_bytes(D);
  auto k2 = attn_bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  k2<<<dim3(B * H, (Lk + kBwdKC - 1) / kBwdKC), kBwdThreads, smem2, stream>>>(
      qp, kp, vp, gp, m, s, c, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, st,
      qscale, scale);
  return cudaGetLastError();
}

template <bool kRecompute>
cudaError_t bwd_dispatch(int dtype, int head_dim, const void* q, const void* k,
                         const void* v, const void* g, float* m, float* s, void* dq,
                         void* dk, void* dv, float* c, int B, int Lq, int Lk, int H,
                         const Strides& st, float qscale, float scale, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return cudaErrorInvalidValue;
  if ((Lq + kBwdBQ - 1) / kBwdBQ > 65535 || (Lk + kBwdKC - 1) / kBwdKC > 65535)
    return cudaErrorInvalidValue;
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
      case 32: DIG_BWD_CASE(__nv_bfloat16, 32);
      case 64: DIG_BWD_CASE(__nv_bfloat16, 64);
      case 128: DIG_BWD_CASE(__nv_bfloat16, 128);
    }
  }
#undef DIG_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
