// fp32 column sum of a row-major [N, C] array, for Hopper (sm_90a), plain C
// interface: the bias gradient of FusedBiasGradDense (dig_tpu_torch/ops/
// fused_dense.py), db = sum(dy, axis=0).
//
// Replaces dig_tpu/ops/fused_dense.py::_colsum_kernel (the Pallas kernel
// called from column_sum), which streams 512-row blocks through VMEM, masks
// the rows past N in the last block, and carries a [1, C] fp32 sum from one
// grid step to the next.
//
// Bound: bytes.  At the fine-tuning and pre-training shapes (dy of fc1,
// 65,536 rows x 1536, bf16) the function reads 201 MB and writes 6 KB:
// ~0.060 ms at 3.35 TB/s, against one add per element (0.1 GFLOP).
//
// Design.  CUDA blocks run in parallel and in no order, so nothing is
// carried from block to block: pass 1 gives each CTA a strip of columns
// (32 lanes x one 16-byte load each: 256 bf16 or 128 fp32 columns) and a
// chunk of 512 rows, the TPU kernel's block; its 8 warps walk every 8th
// row of the chunk (the last chunk stops at N) with coalesced 16-byte
// loads and fp32 sums in registers, meet once in shared memory, and the CTA
// writes one fp32 partial row of its strip.  Pass 2, one thread per column,
// sums the ceil(N / 512) partial rows in chunk order.  No atomics: the
// result does not change from run to run.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 512;

__device__ __forceinline__ void load16(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
colsum_partial_kernel(const T* __restrict__ x, float* __restrict__ part, int n, int c) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kStrip = 32 * VEC;
  __shared__ float red[kWarps][kStrip];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kStrip + lane * VEC;
  const int row0 = blockIdx.y * kChunkRows;
  const int row_end = min(row0 + kChunkRows, n);  // the ragged last chunk stops at N

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (col0 < c) {
    const T* p = x + static_cast<size_t>(row0 + warp) * c + col0;
#pragma unroll 4
    for (int r = row0 + warp; r < row_end; r += kWarps, p += static_cast<size_t>(kWarps) * c) {
      float v[VEC];
      load16(p, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[warp][lane * VEC + i] = acc[i];
  __syncthreads();
  for (int j = threadIdx.x; j < kStrip; j += kThreads) {
    const int col = blockIdx.x * kStrip + j;
    if (col >= c) continue;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][j];
    part[static_cast<size_t>(blockIdx.y) * c + col] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
colsum_finish_kernel(const float* __restrict__ part, float* __restrict__ out, int chunks,
                     int c) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= c) return;
  float t = 0.f;
  for (int i = 0; i < chunks; ++i) t += part[static_cast<size_t>(i) * c + col];
  out[col] = t;
}

template <typename T>
cudaError_t launch(const void* x, float* part, float* out, int n, int c, cudaStream_t stream) {
  constexpr int kStrip = 32 * (16 / sizeof(T));
  const int chunks = (n + kChunkRows - 1) / kChunkRows;
  colsum_partial_kernel<T><<<dim3((c + kStrip - 1) / kStrip, chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), part, n, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_finish_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, out,
                                                                                 chunks, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x: contiguous [n, c], 16-byte
// aligned, c a multiple of 4 (fp32) or 8 (bf16); part: fp32 scratch
// [ceil(n / 512), c]; out: fp32 [c].
int dig_colsum(int dtype, const void* x, void* part, void* out, int n, int c, void* stream) {
  if (n <= 0 || c <= 0 || (n + kChunkRows - 1) / kChunkRows > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      if (c % 4) return cudaErrorInvalidValue;
      return launch<float>(x, pp, op, n, c, st);
    case 1:
      if (c % 8) return cudaErrorInvalidValue;
      return launch<__nv_bfloat16>(x, pp, op, n, c, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
