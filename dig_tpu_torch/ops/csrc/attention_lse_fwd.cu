// Multi-head attention forward with stored row statistics, for Hopper
// (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/attention.py::_attn_kernel_lse (the Pallas kernel
// called from _pallas_attention_lse_fwd_impl).  For each (batch b, head h):
//   logits = (q * (scale * log2e)) . k^T   q scaled in q's dtype, fp32 sums
//   m      = rowmax(logits)                log2 domain, written fp32 [B,Lq,H]
//   e      = exp2(logits - m);  s = sum(e) written fp32 [B,Lq,H]
//   o      = (e cast to v's dtype) . v, fp32 sums, then / s, in q's dtype
// m and s stay in the log2 domain: the backward kernel of the training
// path consumes them.
//
// Bound: at the predict shapes (B=512, L=256, H=6, D=64, bf16) the
// function moves ~409 MB (q, k, v read, o written, m and s written) in
// ~0.12 ms at 3.35 TB/s, against 51.5 GFLOP, ~0.05 ms on the bf16 tensor
// cores: bytes bound it.  This first kernel is simple and correct, not
// fast: it does its products as fp32 FMAs from shared memory, so it is
// bound by the FMA pipes (fp32 peak 67 TFLOP/s -> >= 0.77 ms).  Moving the
// two products onto wgmma is later work.
//
// Design: one CTA owns kBQ = 64 query rows of one (b, h) against all Lk
// keys.  The 64 x Lk fp32 score tile stays in shared memory (64 KB at
// Lk = 256), so the softmax is exact in one pass with no online
// rescaling.  K is staged in 64-key chunks, transposed, for the logits;
// V in 64-key chunks for the output; each thread keeps a 4 x 4 (logits)
// or 4 x D/16 (output) register tile.  q, k and v are read through their
// batch and row strides, so column slices of the packed qkv projection
// [B, L, 3*H*D] are read in place, without a copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kKC = 64;  // keys per staged chunk

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
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

size_t smem_bytes(int head_dim, int lk) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (head_dim + 1) +
                          static_cast<size_t>(head_dim) * (kKC + 1) +
                          static_cast<size_t>(kBQ) * (lk + 1) + kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_lse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ s_out,
                    int Lq, int Lk, int H,
                    long long qbs, long long qrs, long long kbs, long long krs,
                    long long vbs, long long vrs, float qscale) {
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
      const float e = exp2f(row[c] - mx);
      row[c] = round_t<T>(e);  // e.astype(v.dtype) feeds the second product
      sum += e;                // the sum is taken over the fp32 e
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sum_s[r] = sum;
      if (q0 + r < Lq) {
        const size_t at = (static_cast<size_t>(b) * Lq + q0 + r) * H + h;
        m_out[at] = mx;
        s_out[at] = sum;
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* m,
                   float* s, int B, int Lq, int Lk, int H, long long qbs,
                   long long qrs, long long kbs, long long krs, long long vbs,
                   long long vrs, float qscale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Lk);
  auto kernel = attn_lse_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, s, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k, const void* v,
                     void* o, float* m, float* s, int B, int Lq, int Lk, int H,
                     long long qbs, long long qrs, long long kbs, long long krs,
                     long long vbs, long long vrs, float qscale, cudaStream_t st) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    case 64: return launch<T, 64>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    case 128: return launch<T, 128>(q, k, v, o, m, s, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).
// Element (b, l, h, d) of q is at q[b * qbs + l * qrs + h * head_dim + d]
// (same for k, v); o is contiguous [B, Lq, H, head_dim]; m and s are
// contiguous fp32 [B, Lq, H].
int dig_attn_lse_fwd(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, void* o, void* m, void* s, int B, int Lq,
                     int Lk, int H, long long qbs, long long qrs, long long kbs,
                     long long krs, long long vbs, long long vrs, float qscale,
                     void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return cudaErrorInvalidValue;
  if ((Lq + kBQ - 1) / kBQ > 65535) return cudaErrorInvalidValue;
  if (smem_bytes(head_dim, Lk) > 232448) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m);
  float* sp = static_cast<float*>(s);
  switch (dtype) {
    case 0: return dispatch<float>(head_dim, q, k, v, o, mp, sp, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    case 1: return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, mp, sp, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
