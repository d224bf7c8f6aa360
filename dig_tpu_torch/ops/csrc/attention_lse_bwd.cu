// Multi-head attention backward from the forward's stored row statistics,
// for Hopper (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/attention.py::_attn_bwd_kernel_lse (the Pallas
// kernel called from _pallas_attention_lse_bwd).  For each (batch b,
// head h), with m and s the forward's fp32 row max and exp2-sum:
//   logits = (q * (scale * log2e)) . k^T   q scaled in q's dtype, fp32 sums
//   e      = exp2(logits - m);  rs = 1 / s
//   dv     = (e in v's dtype)^T . (do * rs in v's dtype)
//   dw     = (do in v's dtype) . v^T
//   c      = rowsum(dw * e) * rs
//   ds0    = e * (dw - c), rounded to q's dtype
//   dq     = ds0 . k * (scale * rs)
//   dk     = ds0^T . (q * scale * rs in q's dtype)
// with fp32 sums throughout and every rounding where the TPU kernel
// rounds.
//
// Bound: at the pre-training shapes (B = 256 sequences, L = 256, H = 6,
// D = 64, bf16) the function reads q, k, v, do (4 x 50.3 MB) and m, s
// (3.1 MB) and writes dq, dk, dv (3 x 50.3 MB): ~355 MB, ~0.106 ms at
// 3.35 TB/s, against 5 products of 2*B*H*L*L*D = 6.4e10 flop, ~0.065 ms
// on the bf16 tensor cores: bytes bound it.  This first kernel is simple
// and correct, not fast: its products are fp32 FMAs from shared memory
// (the FMA pipes bound it, as they bound the forward kernel), and it
// recomputes two of the five products in its second pass.  Moving the
// products onto wgmma is later work.
//
// Design.  The TPU kernel holds one head's whole 256 x 256 fp32 score tile
// in VMEM and sums dk, dv over the query rows and dq over the keys in one
// body.  A Hopper CTA has 227 KB, so the two reductions are split over two
// launches, as in FlashAttention-2, and neither uses atomics (the result
// does not change from run to run):
//  1. dq pass, one CTA per (b, h, 64 query rows) against all Lk keys.  The
//     64 x Lk tiles e and dw stay in shared memory (2 x 64 KB at Lk = 256),
//     so c is exact in one pass; ds0 overwrites e, and dq = ds0 . k is
//     summed over 64-key chunks.  c is written to a small fp32 [B, Lq, H]
//     scratch for the second pass.
//  2. dk/dv pass, one CTA per (b, h, 64 keys) that walks all queries in
//     64-row chunks, recomputes the 64 x 64 tiles of e and dw from the
//     stored m, s and c, and sums dk and dv in registers.
// The logits and dw are summed in the same order (ascending D, fmaf) in
// both passes and in the forward kernel, so they are bitwise the same
// numbers everywhere and the stored m, s and c belong to them.  q, k, v,
// do and the three gradients are addressed through batch and row strides,
// so column slices of the packed qkv [B, L, 3*H*D] and of its gradient
// are read and written in place.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA (dq pass) / per chunk (dk/dv pass)
constexpr int kKC = 64;  // keys per chunk (dq pass) / per CTA (dk/dv pass)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float to T's precision and back (the "cast to the input dtype"
// steps of the TPU kernel)
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// batch and row strides, in elements, of every [B, L, H, D] operand
struct Strides {
  long long qb, qr, kb, kr, vb, vr, gb, gr, dqb, dqr, dkb, dkr, dvb, dvr;
};

size_t dq_smem_bytes(int head_dim, int lk) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (head_dim + 1) +
                          static_cast<size_t>(head_dim) * (kKC + 1) +
                          2 * static_cast<size_t>(kBQ) * (lk + 1) + 2 * kBQ);
}

size_t dkdv_smem_bytes(int head_dim) {
  return sizeof(float) * (2 * static_cast<size_t>(kKC) * (head_dim + 1) +
                          2 * static_cast<size_t>(head_dim) * (kBQ + 1) +
                          2 * static_cast<size_t>(kKC) * (kBQ + 1) + 3 * kBQ);
}

// Pass 1: dq and c for kBQ query rows of one (b, h).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ m_in, const float* __restrict__ s_in,
                   T* __restrict__ dq, float* __restrict__ c_out, int Lq, int Lk,
                   int H, Strides st, float qscale, float scale) {
  extern __shared__ float smem[];
  const int ld = Lk + 1;
  float* a_s = smem;                   // [kBQ][D + 1]: scaled q, then do
  float* kv_s = a_s + kBQ * (D + 1);   // K^T / V^T chunk [D][kKC + 1], or K chunk [kKC][D]
  float* e_s = kv_s + D * (kKC + 1);   // [kBQ][Lk + 1]: e, then ds0
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

  for (int r = tid; r < kBQ; r += kThreads) {
    const bool ok = q0 + r < Lq;
    const size_t at = (static_cast<size_t>(b) * Lq + q0 + r) * H + h;
    m_s[r] = ok ? m_in[at] : 0.f;
    rs_s[r] = ok ? 1.f / s_in[at] : 0.f;
  }
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float val = 0.f;
    if (q0 + r < Lq) val = round_t<T>(to_f(qb[(q0 + r) * st.qr + d]) * qscale);
    a_s[r * (D + 1) + d] = val;
  }

  const int ty = tid / 16, tx = tid % 16;

  // e = exp2(logits - m), one 64-key chunk at a time
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
        if (col < Lk) e_s[r * ld + col] = exp2f(acc[i][j] - m_s[r]);
      }
  }
  __syncthreads();

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
  const int warp = tid / 32, lane = tid % 32;
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
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ m_in, const float* __restrict__ s_in,
                     const float* __restrict__ c_in, T* __restrict__ dk,
                     T* __restrict__ dv, int Lq, int Lk, int H, Strides st,
                     float qscale, float scale) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* m, const float* s, void* dq, void* dk, void* dv,
                   float* c, int B, int Lq, int Lk, int H, const Strides& st,
                   float qscale, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);

  const size_t smem1 = dq_smem_bytes(D, Lk);
  auto k1 = attn_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  k1<<<dim3(B * H, (Lq + kBQ - 1) / kBQ), kThreads, smem1, stream>>>(
      qp, kp, vp, gp, m, s, static_cast<T*>(dq), c, Lq, Lk, H, st, qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 = dkdv_smem_bytes(D);
  auto k2 = attn_bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  k2<<<dim3(B * H, (Lk + kKC - 1) / kKC), kThreads, smem2, stream>>>(
      qp, kp, vp, gp, m, s, c, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, st,
      qscale, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k, const void* v,
                     const void* g, const float* m, const float* s, void* dq, void* dk,
                     void* dv, float* c, int B, int Lq, int Lk, int H, const Strides& st,
                     float qscale, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, g, m, s, dq, dk, dv, c, B, Lq, Lk, H, st, qscale, scale, stream);
    case 64: return launch<T, 64>(q, k, v, g, m, s, dq, dk, dv, c, B, Lq, Lk, H, st, qscale, scale, stream);
    case 128: return launch<T, 128>(q, k, v, g, m, s, dq, dk, dv, c, B, Lq, Lk, H, st, qscale, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the three gradients
// alike).  Element (b, l, h, d) of q is at q[b * qbs + l * qrs + h * head_dim
// + d], and likewise for k, v, do (g*), dq, dk and dv with their own batch
// and row strides; m and s are the forward's contiguous fp32 [B, Lq, H]; c
// is a contiguous fp32 [B, Lq, H] scratch.  qscale is scale * log2(e)
// rounded to the input dtype, as the forward kernel takes it.
int dig_attn_lse_bwd(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* g, const void* m, const void* s,
                     void* dq, void* dk, void* dv, void* c, int B, int Lq, int Lk,
                     int H, long long qbs, long long qrs, long long kbs, long long krs,
                     long long vbs, long long vrs, long long gbs, long long grs,
                     long long dqbs, long long dqrs, long long dkbs, long long dkrs,
                     long long dvbs, long long dvrs, float qscale, float scale,
                     void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return cudaErrorInvalidValue;
  if ((Lq + kBQ - 1) / kBQ > 65535 || (Lk + kKC - 1) / kKC > 65535) return cudaErrorInvalidValue;
  if (dq_smem_bytes(head_dim, Lk) > 232448 || dkdv_smem_bytes(head_dim) > 232448)
    return cudaErrorInvalidValue;
  const Strides st{qbs, qrs, kbs, krs, vbs, vrs, gbs, grs, dqbs, dqrs, dkbs, dkrs, dvbs, dvrs};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(m);
  const float* sp = static_cast<const float*>(s);
  float* cp = static_cast<float*>(c);
  switch (dtype) {
    case 0: return dispatch<float>(head_dim, q, k, v, g, mp, sp, dq, dk, dv, cp, B, Lq, Lk, H, st, qscale, scale, stm);
    case 1: return dispatch<__nv_bfloat16>(head_dim, q, k, v, g, mp, sp, dq, dk, dv, cp, B, Lq, Lk, H, st, qscale, scale, stm);
    default: return cudaErrorInvalidValue;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
