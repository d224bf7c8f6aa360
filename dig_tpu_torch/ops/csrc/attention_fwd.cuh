// The multi-head attention forward kernel shared by attention_lse_fwd.cu
// (the stored-statistics variant) and attention_fwd.cu (the recompute
// variant and its bf16-exponential branch).  For each (batch b, head h):
//   logits = (q * (scale * log2e)) . k^T   q scaled in q's dtype, fp32 sums
//   m      = rowmax(logits)                log2 domain
//   e      = exp2(logits - m);  s = sum(e)
//   o      = (e cast to v's dtype) . v, fp32 sums, then / s, in q's dtype
// kStats also writes m and s (fp32 [B, Lq, H]) for the backward kernel.
// kBf16Exp (bf16 inputs only) takes the exponential of the centred logits
// rounded to bf16 and rounds e to bf16; s is then the fp32 sum of those
// bf16 e's, as the TPU kernel's ones-column appended to v sums them.
//
// Design: one CTA owns kBQ = 64 query rows of one (b, h) against all Lk
// keys.  The 64 x Lk fp32 score tile stays in shared memory (64 KB at
// Lk = 256), so the softmax is exact in one pass with no online
// rescaling.  K is staged in 64-key chunks, transposed, for the logits;
// V in 64-key chunks for the output; each thread keeps a 4 x 4 (logits)
// or 4 x D/16 (output) register tile.  q, k and v are read through their
// batch and row strides, so column slices of the packed qkv projection
// [B, L, 3*H*D] are read in place, without a copy.  The logits are summed
// in ascending D with fmaf, and the row max and sum are taken in one fixed
// order, as the backward kernels take them (attention_bwd.cuh).
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdBQ = 64;  // query rows per CTA
constexpr int kFwdKC = 64;  // keys per staged chunk

enum class FwdMode { kStats, kPlain, kBf16Exp };

size_t fwd_smem_bytes(int head_dim, int lk) {
  return sizeof(float) * (static_cast<size_t>(kFwdBQ) * (head_dim + 1) +
                          static_cast<size_t>(head_dim) * (kFwdKC + 1) +
                          static_cast<size_t>(kFwdBQ) * (lk + 1) + kFwdBQ);
}

template <typename T, int D, FwdMode M>
__global__ void __launch_bounds__(kFwdThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ m_out, float* __restrict__ s_out,
                int Lq, int Lk, int H,
                long long qbs, long long qrs, long long kbs, long long krs,
                long long vbs, long long vrs, float qscale) {
  constexpr int kThreads = kFwdThreads, kBQ = kFwdBQ, kKC = kFwdKC;
  extern __shared__ float smem[];
  const int ld_s = Lk + 1;
  float* q_s = smem;                    // [kBQ][D + 1] scaled q
  float* kv_s = q_s + kBQ * (D + 1);    // K^T chunk [D][kKC + 1] or V chunk [kKC][D]
  float* sc_s = kv_s + D * (kKC + 1);   // scores, then e in v's precision [kBQ][Lk + 1]
  float* sum_s = sc_s + kBQ * ld_s;     // row sums [kBQ]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + b * qbs + h * D;
  const T* kb = k + b * kbs + h * D;
  const T* vb = v + b * vbs + h * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float val = 0.f;
    if (q0 + r < Lq) val = round_t<T>(to_f(qb[(q0 + r) * qrs + d]) * qscale);
    q_s[r * (D + 1) + d] = val;
  }

  const int ty = tid / 16, tx = tid % 16;

  // logits, one 64-key chunk at a time
  for (int k0 = 0; k0 < Lk; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      kv_s[d * (kKC + 1) + j] = (k0 + j < Lk) ? to_f(kb[(k0 + j) * krs + d]) : 0.f;
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
      if constexpr (M == FwdMode::kBf16Exp) {
        // exp2 of the centred logit rounded to bf16, itself rounded to bf16;
        // the sum is over those bf16 values (the ones-column of the TPU kernel)
        const float e = round_t<T>(exp2f(round_t<T>(row[c] - mx)));
        row[c] = e;
        sum += e;
      } else {
        const float e = exp2f(row[c] - mx);
        row[c] = round_t<T>(e);  // e.astype(v.dtype) feeds the second product
        sum += e;                // the sum is taken over the fp32 e
      }
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
      kv_s[j * D + d] = (k0 + j < Lk) ? to_f(vb[(k0 + j) * vrs + d]) : 0.f;
    }
    __syncthreads();
    const int kn = min(kKC, Lk - k0);
    // The unroll of this loop moves these FMA-bound kernels by up to 1.5x
    // on the H100, and not alike in the modes: the compiler's own choice
    // suits kStats, no unrolling the two modes that store nothing.  The
    // body is the same in both branches.
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
    T* orow = o + ((static_cast<size_t>(b) * Lq + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / s);
  }
}

template <typename T, int D, FwdMode M>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o, float* m,
                       float* s, int B, int Lq, int Lk, int H, long long qbs,
                       long long qrs, long long kbs, long long krs, long long vbs,
                       long long vrs, float qscale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(D, Lk);
  auto kernel = attn_fwd_kernel<T, D, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Lq + kFwdBQ - 1) / kFwdBQ);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, s, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale);
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

// the launch limits both C entries check first
bool fwd_shape_ok(int head_dim, int B, int Lq, int Lk, int H) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return false;
  if ((Lq + kFwdBQ - 1) / kFwdBQ > 65535) return false;
  return fwd_smem_bytes(head_dim, Lk) <= 232448;
}

}  // namespace
