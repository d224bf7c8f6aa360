// The logits of the two tensor-core instructions the attention kernels use,
// side by side, for Hopper (sm_90a), plain C interface: wgmma (the
// forward's wg_logits, attention_fwd.cuh) and mma.sync (the backward's
// chunk_logits) on the same bf16 q and k.  Not on any path of the model:
// chip_smoke.py and tools/time_attention_fwd.py report whether the two
// give the same bits, which decides whether an e formed from one with the
// max of the other can exceed 1 (attention_bwd.cuh).  Also the forward
// body's shared memory a block, which ptxas does not report (it is
// dynamic).

#include "attention_fwd.cuh"

namespace {

constexpr int kProbeD = 64;  // the model's head_dim

// load_rows into a swizzled tile (dst 1024-byte aligned), as TMA lays it out
template <int D>
__device__ __forceinline__ void load_rows_sw(uint32_t dst, const bf16* src, long long rs, int r0,
                                             int L, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kFwdBQ * kChunks / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = c / kChunks, p = c % kChunks;
    const bool ok = r0 + r < L;
    cp_async_16(dst + sw_chunk<D>(r, p), src + (ok ? (r0 + r) * rs : 0) + p * 8, ok ? 16 : 0);
  }
}

// one block a pair of 64 x 64 tiles: q [64, D] and k [64, D], contiguous
__global__ void __launch_bounds__(kMmaThreads)
logits_probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    float* __restrict__ out_wgmma, float* __restrict__ out_mma, float qscale) {
  constexpr int kPad = kFwdBQ * mma_ld<kProbeD>();
  __shared__ __align__(16) bf16 q_pad[kPad];
  __shared__ __align__(16) bf16 k_pad[kPad];
  __shared__ __align__(16) unsigned char k_raw[tile_bytes<kProbeD>() + 1024];
  const uint32_t k_sw = (smem_addr(k_raw) + 1023) & ~1023u;  // the swizzled tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t at = static_cast<size_t>(blockIdx.x) * kFwdBQ * kProbeD;
  load_rows<kProbeD>(q_pad, q + at, kProbeD, 0, kFwdBQ, tid);
  load_rows<kProbeD>(k_pad, k + at, kProbeD, 0, kFwdBQ, tid);
  load_rows_sw<kProbeD>(k_sw, k + at, kProbeD, 0, kFwdBQ, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  uint32_t qa[kProbeD / 16][4];
  load_a_rows<kProbeD>(qa, smem_addr(q_pad), warp, lane);
  scale_a_rows<kProbeD>(qa, qscale);
  float s_mma[8][4], s_wg[8][4];
  chunk_logits<kProbeD>(qa, smem_addr(k_pad), lane, s_mma);
  wg_logits<kProbeD>(qa, k_sw, s_wg);
  const int g = lane >> 2, col0 = 2 * (lane & 3);
  float* const wg_tile = out_wgmma + static_cast<size_t>(blockIdx.x) * kFwdBQ * kFwdKC;
  float* const mma_tile = out_mma + static_cast<size_t>(blockIdx.x) * kFwdBQ * kFwdKC;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at2 = (warp * 16 + g + 8 * (i >> 1)) * kFwdKC + n * 8 + col0 + (i & 1);
      wg_tile[at2] = s_wg[n][i];
      mma_tile[at2] = s_mma[n][i];
    }
}

}  // namespace

extern "C" {

// q, k: contiguous bf16 [n, 64, 64]; out_wgmma, out_mma: fp32 [n, 64, 64],
// the logits (q * qscale in bf16) . k^T of each pair by each instruction
int dig_attn_logits_probe(const void* q, const void* k, void* out_wgmma, void* out_mma, int n,
                          float qscale, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  logits_probe_kernel<<<n, kMmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(out_wgmma),
      static_cast<float*>(out_mma), qscale);
  return cudaGetLastError();
}

// bytes of dynamic shared memory a block of the bf16 forward body takes at
// head_dim (attention_fwd.cuh wg_smem_bytes), or -1
long long dig_attn_fwd_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 32: return static_cast<long long>(wg_smem_bytes<32>());
    case 64: return static_cast<long long>(wg_smem_bytes<64>());
    case 128: return static_cast<long long>(wg_smem_bytes<128>());
    default: return -1;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
