// The logits of the operand forms the attention kernels take, side by side,
// for Hopper (sm_90a), plain C interface, on the same bf16 q and k (q
// scaled in bf16 as the kernels scale it):
//  * fwd:  the forward's wg_logits (attention_fwd.cuh): wgmma, the scaled q
//          as A fragments loaded by ldmatrix, K read K-major;
//  * mma:  mma.sync m16n8k16 from ldmatrix fragments (the backward's
//          instruction before its Hopper bodies; reported only);
//  * rows: the backward row pass's logits: wg_logits with the A fragments
//          loaded by 32-bit shared-memory loads (load_a_rows_lds);
//  * cols: the backward column pass's logits^T = k . (q * qscale)^T by
//          wgmma with both operands in shared memory (wg_ss_issue: keys as
//          the rows, the scaled q tile formed in shared memory as the
//          column pass forms it), written back transposed.
// Not on any path of the model: chip_smoke.py fails unless rows and cols
// equal fwd bit for bit, which #2 == #4 and e <= 1 in the backward rest on
// (attention_bwd.cuh).  Also each bf16 attention body's shared memory a
// block, which ptxas does not report (it is dynamic).

#include "attention_bwd.cuh"

namespace {

constexpr int kProbeD = 64;  // the model's head_dim
constexpr int kProbeThreads = 128;  // one warpgroup: 4 warps x 16 rows
// row stride of a padded tile, in elements: 16 bytes of padding put the 8
// rows an ldmatrix reads on 8 different groups of 4 banks
constexpr int kLd = kProbeD + 8;

// rows [0, 64) of a contiguous [64, D] bf16 block into a padded tile
__device__ __forceinline__ void load_padded(bf16* dst, const bf16* src, int tid) {
  constexpr int kChunks = kProbeD / 8;
  for (int c = tid; c < kFwdBQ * kChunks; c += kProbeThreads)
    cp_async_16(smem_addr(dst + (c / kChunks) * kLd + (c % kChunks) * 8),
                src + (c / kChunks) * kProbeD + (c % kChunks) * 8, 16);
}

// the same into a swizzled tile (TMA's layout), times f in bf16 unless f is 1
__device__ __forceinline__ void load_swizzled(unsigned char* dst, const bf16* src, int tid,
                                              float f) {
  constexpr int kChunks = kProbeD / 8;
  for (int c = tid; c < kFwdBQ * kChunks; c += kProbeThreads) {
    const int r = c / kChunks, p = c % kChunks;
    const uint4 x = *reinterpret_cast<const uint4*>(src + r * kProbeD + p * 8);
    *reinterpret_cast<uint4*>(dst + sw_chunk<kProbeD>(r, p)) = f == 1.f ? x : scale_chunk(x, f);
  }
}

// the A fragments of a warp's 16 rows of a padded tile (ldmatrix)
__device__ __forceinline__ void load_a_padded(uint32_t (&a)[kProbeD / 16][4], uint32_t tile,
                                              int warp, int lane) {
  const uint32_t base = tile + ((warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kk = 0; kk < kProbeD / 16; ++kk) ldmatrix_x4(a[kk], base + kk * 32);
}

// a warp's 16 rows' logits against 64 keys by mma.sync, 8 keys an entry,
// summed over D in ascending k16 steps from zero
__device__ __forceinline__ void mma_logits(const uint32_t (&qa)[kProbeD / 16][4], uint32_t k_tile,
                                           int lane, float (&s)[8][4]) {
  constexpr int kRow = kLd * 2;  // bytes
  // lanes 0-7: keys 0-7, d 0-7; 8-15: keys 0-7, d 8-15; 16-23: keys 8-15,
  // d 0-7; 24-31: keys 8-15, d 8-15 -> b0, b1 of two adjacent key tiles
  const uint32_t base = k_tile + ((lane & 7) + ((lane >> 4) << 3)) * kRow + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int kk = 0; kk < kProbeD / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, base + np * 16 * kRow + kk * 32);
      mma_bf16_16816(s[2 * np], qa[kk], b[0], b[1]);
      mma_bf16_16816(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
}

// one block a pair of 64 x 64 tiles: q [64, D] and k [64, D], contiguous
__global__ void __launch_bounds__(kProbeThreads)
logits_probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    float* __restrict__ out_fwd, float* __restrict__ out_mma,
                    float* __restrict__ out_rows, float* __restrict__ out_cols, float qscale) {
  constexpr uint32_t kTile = tile_bytes<kProbeD>();
  __shared__ __align__(16) bf16 q_pad[kFwdBQ * kLd];
  __shared__ __align__(16) bf16 k_pad[kFwdBQ * kLd];
  // swizzled tiles: q, k, the scaled q
  __shared__ __align__(16) unsigned char sw_raw[3 * kTile + 1024];
  const uint32_t q_sw = (smem_addr(sw_raw) + 1023) & ~1023u, k_sw = q_sw + kTile,
                 qs_sw = k_sw + kTile;
  unsigned char* const sw = sw_raw + (q_sw - smem_addr(sw_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t at = static_cast<size_t>(blockIdx.x) * kFwdBQ * kProbeD;
  load_padded(q_pad, q + at, tid);
  load_padded(k_pad, k + at, tid);
  cp_async_commit();
  load_swizzled(sw, q + at, tid, 1.f);
  load_swizzled(sw + kTile, k + at, tid, 1.f);
  load_swizzled(sw + 2 * kTile, q + at, tid, qscale);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  uint32_t qa[kProbeD / 16][4];
  float s[8][4];
  const int g = lane >> 2, col0 = 2 * (lane & 3);
  auto write = [&](float* out, bool transposed) {
    float* const tile = out + static_cast<size_t>(blockIdx.x) * kFwdBQ * kFwdKC;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 16 + g + 8 * (i >> 1), c = n * 8 + col0 + (i & 1);
        tile[transposed ? c * kFwdBQ + r : r * kFwdKC + c] = s[n][i];
      }
  };
  load_a_padded(qa, smem_addr(q_pad), warp, lane);
  scale_a_rows<kProbeD>(qa, qscale);
  mma_logits(qa, smem_addr(k_pad), lane, s);
  write(out_mma, false);
  wg_logits<kProbeD>(qa, k_sw, s);
  write(out_fwd, false);
  scaled_q_rows<kProbeD>(qa, sw, warp, lane, qscale);
  wg_logits<kProbeD>(qa, k_sw, s);
  write(out_rows, false);
  wg_ss<kProbeD>(k_sw, qs_sw, s);  // rows: keys, columns: queries
  write(out_cols, true);
}

}  // namespace

extern "C" {

// q, k: contiguous bf16 [n, 64, 64]; out_*: fp32 [n, 64 queries, 64 keys],
// the logits (q * qscale in bf16) . k^T of each pair in each form
int dig_attn_logits_forms(const void* q, const void* k, void* out_fwd, void* out_mma,
                          void* out_rows, void* out_cols, int n, float qscale, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  logits_probe_kernel<<<n, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(out_fwd),
      static_cast<float*>(out_mma), static_cast<float*>(out_rows), static_cast<float*>(out_cols),
      qscale);
  return cudaGetLastError();
}

// bytes of dynamic shared memory a block of a bf16 attention body takes at
// head_dim: which 0 = the forward (attention_fwd.cuh wg_smem_bytes), 1 =
// the backward's row pass, 2 = its column pass (attention_bwd.cuh); or -1
long long dig_attn_smem_bytes(int which, int head_dim) {
  auto pick = [&](size_t d32, size_t d64, size_t d128) -> long long {
    return head_dim == 32 ? d32 : head_dim == 64 ? d64 : head_dim == 128 ? d128 : -1;
  };
  switch (which) {
    case 0: return pick(wg_smem_bytes<32>(), wg_smem_bytes<64>(), wg_smem_bytes<128>());
    case 1: return pick(rows_smem_bytes<32>(), rows_smem_bytes<64>(), rows_smem_bytes<128>());
    case 2: return pick(cols_smem_bytes<32>(), cols_smem_bytes<64>(), cols_smem_bytes<128>());
    default: return -1;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
