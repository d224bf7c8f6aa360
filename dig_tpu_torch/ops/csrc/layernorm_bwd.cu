// Row LayerNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/layernorm.py::_ln_bwd_kernel (the Pallas kernel
// called from _pallas_ln_vjp_bwd).  Per row of x (c values), with the
// statistics recomputed in fp32 as the forward takes them:
//   xhat = (x - mu) * rstd,  dyg = dy * g
//   dx   = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))   in x's dtype
// and over all rows dgamma = sum(dy * xhat), dbeta = sum(dy) in fp32.  The
// TPU kernel leaves per-block partial sums to its caller; here the C entry
// finishes them with a second small kernel on the same stream.
//
// Bound: bytes.  At the pre-training shapes (65,536 rows x 384, bf16) the
// kernel reads x and dy and writes dx, 3 x 50.3 MB ~ 151 MB, ~0.045 ms at
// 3.35 TB/s, against ~16 flops per element.
//
// Design: a stream that never drains.
// - A persistent grid: as many blocks as the card holds at once (SM count x
//   the occupancy the runtime reports for this build), each warp walking
//   rows with a grid stride.  No wave ends part empty, and there is one
//   partial dgamma, dbeta row per block, a few hundred in all.  A block no
//   longer owns a fixed 128 rows (the constant ops/layernorm.py mirrored as
//   `_BWD_ROWS` is gone): `dig_ln_bwd_blocks` tells the wrapper the grid.
// - Loads ahead of the arithmetic: a warp asks for its next row's x and dy
//   (kept as loaded, bf16 still packed) before it reduces the row it holds,
//   so a row's four shuffle chains run under the next row's loads.  The
//   register budget is left to the compiler (96-106 registers, two blocks an
//   SM): every cap that made it spill cost more than the occupancy gave.
// - One warp per row, the row in registers (N4 chunks of 4 consecutive
//   values per lane, coalesced 16-byte or 8-byte loads), the mean and the
//   centred second moment two-pass, in the forward kernel's order
//   (layernorm_fwd.cu), so the statistics are the forward's; mean(dyg) and
//   mean(dyg * xhat) share one shuffle chain.
// - Each warp keeps its dgamma, dbeta sums in registers; at the end the 8
//   warps' sums meet in shared memory in a fixed order and the block writes
//   one partial row.  `ln_bwd_finish_kernel` sums the partial rows in a
//   fixed order.  No floating-point atomics anywhere: two calls on the same
//   inputs give the same bits.
// Tried on the card and not kept (PERF.md): per-warp shared-memory rings
// filled by `cp.async.bulk` on an mbarrier (2-8 stages, 1 or 2 rows a copy),
// register caps for 3 or 4 blocks an SM, 128 and 512 threads, streaming
// cache hints.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
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
constexpr int kMaxC = 1024;
constexpr int kFinishCols = 32;   // finishing kernel: columns a block ...
constexpr int kFinishRows = 16;   // ... and row groups (threads: cols x groups)

// a row's chunk as it is loaded: 4 values, bf16 still packed
template <typename T> struct Raw;
template <> struct Raw<float> { using type = float4; };
template <> struct Raw<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void unpack4(const float4& t, float v[4]) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void unpack4(const uint2& t, float v[4]) {
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T, int N4>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ part, int rows, float eps) {
  constexpr int C = N4 * 128;
  using R = typename Raw<T>::type;
  __shared__ float red[kWarps * C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kWarps + warp;
  const int stride = gridDim.x * kWarps;

  float gv[N4][4], dg[N4][4], db[N4][4];
#pragma unroll
  for (int j = 0; j < N4; ++j) {
    load4(g + (j * 32 + lane) * 4, gv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) dg[j][i] = db[j][i] = 0.f;
  }

  R nx[N4], nd[N4];  // the row in flight
  auto request = [&](int row) {
    const size_t off = static_cast<size_t>(row) * C;
#pragma unroll
    for (int j = 0; j < N4; ++j) {
      nx[j] = *reinterpret_cast<const R*>(x + off + (j * 32 + lane) * 4);
      nd[j] = *reinterpret_cast<const R*>(dy + off + (j * 32 + lane) * 4);
    }
  };
  if (first < rows) request(first);
  for (int row = first; row < rows; row += stride) {
    float v[N4][4], d[N4][4];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N4; ++j) {
      unpack4(nx[j], v[j]);
      unpack4(nd[j], d[j]);
      sum += (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
    }
    if (row + stride < rows) request(row + stride);  // lands while this row reduces
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // one chain for both sums
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / C;
    const float m2 = s2 / C;
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

  // the 8 warps' sums -> one partial row per block, dgamma then dbeta
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
      part[(static_cast<size_t>(blockIdx.x) * 2 + which) * C + col] = t;
    }
    __syncthreads();
  }
}

// part: [nparts, 2c] (a block's dgamma row, then its dbeta row) -> out [2c],
// each column summed over the partial rows in a fixed order
__global__ void __launch_bounds__(kFinishCols * kFinishRows)
ln_bwd_finish_kernel(const float* __restrict__ part, float* __restrict__ out, int nparts,
                     int c2) {
  __shared__ float red[kFinishRows][kFinishCols + 1];
  const int col = blockIdx.x * kFinishCols + threadIdx.x;
  float t = 0.f;
  if (col < c2)
    for (int p = threadIdx.y; p < nparts; p += kFinishRows)
      t += part[static_cast<size_t>(p) * c2 + col];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && col < c2) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kFinishRows; ++i) total += red[i][threadIdx.x];
    out[col] = total;
  }
}

// blocks of the persistent grid: what the card holds at once, and no more
// than one warp per row needs
template <typename T, int N4>
cudaError_t grid_blocks(int rows, int* blocks) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ln_bwd_kernel<T, N4>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorLaunchOutOfResources;
  const int need = (rows + kWarps - 1) / kWarps;
  *blocks = sms * occ < need ? sms * occ : need;
  return cudaSuccess;
}

// blocks_out: only report the grid size
template <typename T, int N4>
cudaError_t launch(const void* x, const float* g, const void* dy, void* dx, float* out,
                   float* part, int blocks, int rows, float eps, cudaStream_t stream,
                   int* blocks_out) {
  if (blocks_out) return grid_blocks<T, N4>(rows, blocks_out);
  ln_bwd_kernel<T, N4><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), g, static_cast<const T*>(dy), static_cast<T*>(dx), part, rows,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int c2 = 2 * N4 * 128;
  ln_bwd_finish_kernel<<<(c2 + kFinishCols - 1) / kFinishCols, dim3(kFinishCols, kFinishRows), 0,
                         stream>>>(part, out, blocks, c2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* g, const void* dy, void* dx, float* out,
                     float* part, int blocks, int rows, int c, float eps, cudaStream_t stream,
                     int* blocks_out) {
  switch (c / 128) {
#define DIG_LN_CASE(N) \
  case N: return launch<T, N>(x, g, dy, dx, out, part, blocks, rows, eps, stream, blocks_out);
    DIG_LN_CASE(1) DIG_LN_CASE(2) DIG_LN_CASE(3) DIG_LN_CASE(4)
    DIG_LN_CASE(5) DIG_LN_CASE(6) DIG_LN_CASE(7) DIG_LN_CASE(8)
#undef DIG_LN_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t entry(int dtype, const void* x, const void* g, const void* dy, void* dx, void* out,
                  void* part, int blocks, int rows, int c, float eps, void* stream,
                  int* blocks_out) {
  if (c % 128 != 0 || c < 128 || c > kMaxC || rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, gp, dy, dx, op, pp, blocks, rows, c, eps, s, blocks_out);
    case 1:
      return dispatch<__nv_bfloat16>(x, gp, dy, dx, op, pp, blocks, rows, c, eps, s, blocks_out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The number of blocks of `dig_ln_bwd`'s persistent grid for this dtype and
// shape on the current device: what the card holds at once (SM count x
// occupancy), at most one warp per row.  A CUDA error code, negated, on
// failure.
int dig_ln_bwd_blocks(int dtype, int rows, int c) {
  int blocks = 0;
  const cudaError_t err = entry(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                                rows, c, 0.f, nullptr, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx alike).  x, dy, dx:
// [rows, c] contiguous, 16-byte aligned, rows >= 1; g: fp32 [c]; out: fp32
// [2, c], dgamma then dbeta; part: fp32 scratch [blocks, 2, c], blocks as
// `dig_ln_bwd_blocks` gave it.  c % 128 == 0 and c <= 1024.  Two launches on
// `stream`.
int dig_ln_bwd(int dtype, const void* x, const void* g, const void* dy, void* dx, void* out,
               void* part, int blocks, int rows, int c, float eps, void* stream) {
  if (blocks < 1) return cudaErrorInvalidValue;
  return entry(dtype, x, g, dy, dx, out, part, blocks, rows, c, eps, stream, nullptr);
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
