// Row LayerNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/layernorm.py::_ln_bwd_kernel (the Pallas kernel
// called from _pallas_ln_vjp_bwd).  Per row of x (c values), with the
// statistics recomputed in fp32 as the forward takes them:
//   xhat = (x - mu) * rstd,  dyg = dy * g
//   dx   = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))   in x's dtype
// and per block of rows one fp32 partial row of dgamma = sum(dy * xhat) and
// of dbeta = sum(dy); the wrapper sums the partials over the blocks, as
// the JAX package sums its kernel's per-block partials outside the kernel.
//
// Bound: bytes.  At the pre-training shapes (65,536 rows x 384, bf16) the
// kernel reads x and dy and writes dx, 3 x 50.3 MB ~ 151 MB, ~0.045 ms at
// 3.35 TB/s; the partials add 512 x 384 x 2 fp32 values (1.6 MB) against
// ~15 flops per element.
//
// Design: one warp per row, as in the forward: the row of x and of dy sits
// in registers (N4 chunks of 4 consecutive values per lane, coalesced
// 16-byte or 8-byte loads), the statistics take the forward kernel's
// two-pass variance, and nothing is shared between warps while the rows
// stream.  A CTA owns kRowsPerCta consecutive rows; each of its 8 warps
// walks every 8th of them and keeps its own dgamma, dbeta sums in
// registers; at the end the 8 warps' sums meet in shared memory and the
// CTA writes one partial row.  A Pallas grid step may carry a sum to the
// next; CUDA blocks run in parallel and in no order, so nothing is carried
// from one block to another, and the fixed order of the sums keeps the
// result the same from run to run.

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
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = 128;  // one partial row per 128 rows (mirrored in ops/layernorm.py)
constexpr int kMaxC = 1024;

template <typename T, int N4>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ dg_part, float* __restrict__ db_part, int rows,
              float eps) {
  constexpr int C = N4 * 128;
  __shared__ float red[kWarps * C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerCta;

  float gv[N4][4], dg[N4][4], db[N4][4];
#pragma unroll
  for (int j = 0; j < N4; ++j) {
    load4(g + (j * 32 + lane) * 4, gv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) dg[j][i] = db[j][i] = 0.f;
  }

  for (int r = warp; r < kRowsPerCta; r += kWarps) {
    const int row = row0 + r;
    if (row >= rows) break;
    const T* xr = x + static_cast<size_t>(row) * C;
    const T* dyr = dy + static_cast<size_t>(row) * C;
    float v[N4][4], d[N4][4];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N4; ++j) {
      load4(xr + (j * 32 + lane) * 4, v[j]);
      load4(dyr + (j * 32 + lane) * 4, d[j]);
      sum += (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < N4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = v[j][i] - mu;
        sq += t * t;
      }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < N4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[j][i] = (v[j][i] - mu) * rstd;  // xhat from here on
        const float dyg = d[j][i] * gv[j][i];
        s1 += dyg;
        s2 += dyg * v[j][i];
        dg[j][i] += d[j][i] * v[j][i];
        db[j][i] += d[j][i];
      }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
    T* dxr = dx + static_cast<size_t>(row) * C;
#pragma unroll
    for (int j = 0; j < N4; ++j) {
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[i] = rstd * (d[j][i] * gv[j][i] - m1 - v[j][i] * m2);
      store4(dxr + (j * 32 + lane) * 4, out);
    }
  }

  // the 8 warps' sums -> one partial row per CTA, dgamma then dbeta
  float* part[2] = {dg_part, db_part};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < N4; ++j) {
      float* dst = red + warp * C + (j * 32 + lane) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = which == 0 ? dg[j][i] : db[j][i];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < C; col += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w * C + col];
      part[which][static_cast<size_t>(blockIdx.x) * C + col] = t;
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const void* dy, void* dx, float* dg,
                   float* db, int rows, int c, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta);
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  switch (c / 128) {
#define DIG_LN_CASE(N)                                                                \
  case N:                                                                             \
    ln_bwd_kernel<T, N><<<grid, kThreads, 0, stream>>>(xp, g, dyp, dxp, dg, db, rows, eps); \
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

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx alike).  x, dy, dx:
// [rows, c] contiguous, 16-byte aligned; g: fp32 [c]; dg, db: fp32
// [ceil(rows / 128), c], one partial row per 128 rows.  c % 128 == 0 and
// c <= 1024.
int dig_ln_bwd(int dtype, const void* x, const void* g, const void* dy, void* dx,
               void* dg, void* db, int rows, int c, float eps, void* stream) {
  if (c % 128 != 0 || c < 128 || c > kMaxC || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  float* dgp = static_cast<float*>(dg);
  float* dbp = static_cast<float*>(db);
  switch (dtype) {
    case 0: return launch<float>(x, gp, dy, dx, dgp, dbp, rows, c, eps, s);
    case 1: return launch<__nv_bfloat16>(x, gp, dy, dx, dgp, dbp, rows, c, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
