// Row LayerNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/layernorm.py::_ln_fwd_kernel (the Pallas kernel
// called from _pallas_ln_fwd_impl).  y = (x - mu) * rsqrt(var + eps) * g + b
// over the last axis, statistics in fp32, output in x's dtype; g and b are
// fp32.
//
// Bound: bytes.  Each row is read once and written once (c = 384 on the
// predict path: 768 B in, 768 B out in bf16) against 8 flops per element,
// so the kernel can at best stream at the card's memory rate.
//
// Design: one warp per row; a row of c = 128 * N4 values lives in
// registers (N4 chunks of 4 consecutive values per lane, neighbouring
// lanes on neighbouring 4-value chunks, so every load is coalesced).  The
// TPU kernel takes the variance as E[x^2] - mu^2 in one pass; with the row
// in registers a second pass costs no extra bytes, so the variance here is
// the two-pass E[(x - mu)^2], which is what the plain version `_ln_ref`
// computes.  The two differ by fp32 rounding only (|dy| <~ 1e-5 at
// |x| ~ 1, see tests/test_torch_port_ops.py).  Eight rows per 256-thread
// block; nothing is shared between warps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T, int N4>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, T* __restrict__ y, int rows, float eps) {
  constexpr int C = N4 * 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * C;
  T* yr = y + static_cast<size_t>(row) * C;

  float v[N4][4];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < N4; ++j) {
    load4(xr + (j * 32 + lane) * 4, v[j]);
    sum += (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
  }
  const float mu = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < N4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = v[j][i] - mu;
      sq += d * d;
    }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
  for (int j = 0; j < N4; ++j) {
    const int col = (j * 32 + lane) * 4;
    float gv[4], bv[4], out[4];
    load4(g + col, gv);
    load4(b + col, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (v[j][i] - mu) * rstd * gv[i] + bv[i];
    store4(yr + col, out);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const float* b, void* y,
                   int rows, int c, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  switch (c / 128) {
#define DIG_LN_CASE(N)                                                         \
  case N:                                                                      \
    ln_fwd_kernel<T, N><<<grid, kThreads, 0, stream>>>(xp, g, b, yp, rows, eps); \
    break;
    DIG_LN_CASE(1) DIG_LN_CASE(2) DIG_LN_CASE(3) DIG_LN_CASE(4)
    DIG_LN_CASE(5) DIG_LN_CASE(6) DIG_LN_CASE(7) DIG_LN_CASE(8)
#undef DIG_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: [rows, c]
// contiguous, 16-byte aligned; c % 128 == 0 and c <= 1024.
int dig_ln_fwd(int dtype, const void* x, const void* g, const void* b, void* y,
               int rows, int c, float eps, void* stream) {
  if (c % 128 != 0 || c < 128 || c > 1024 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  switch (dtype) {
    case 0: return launch<float>(x, gp, bp, y, rows, c, eps, s);
    case 1: return launch<__nv_bfloat16>(x, gp, bp, y, rows, c, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
