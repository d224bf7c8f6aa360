// Multi-head attention forward with stored row statistics, for Hopper
// (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/attention.py::_attn_kernel_lse (the Pallas kernel
// called from _pallas_attention_lse_fwd_impl): the body of
// attention_fwd.cuh in its kStats mode, which also writes each row's max m
// and exp2-sum s (fp32 [B, Lq, H], log2 domain) for the backward kernel of
// the training path (attention_lse_bwd.cu).
//
// Bound: at the predict shapes (B = 512, L = 256, H = 6, D = 64, bf16) the
// function moves 409 MB (q, k, v read, o written, m and s written), 0.122
// ms at 3.35 TB/s, against 51.5 GFLOP (two products), 0.052 ms on the bf16
// tensor cores: bytes bound it.  bf16 runs the TMA / wgmma body (a
// persistent, warp-specialised block an SM: a producer warpgroup loads Q, K
// and V tiles by TMA through an mbarrier ring, two consumer warpgroups take
// 128 query rows of one (b, h) with one sweep over K, the logits of up to
// 256 keys in registers: see the header); fp32 the FMA body, the parity
// path.

#include "attention_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).
// Element (b, l, h, d) of q is at q[b * qbs + l * qrs + h * head_dim + d]
// (same for k, v); o is contiguous [B, Lq, H, head_dim]; m and s are
// contiguous fp32 [B, Lq, H].  bf16 operands need 16-byte aligned rows
// (base addresses, and batch and row strides a multiple of 8).
int dig_attn_lse_fwd(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, void* o, void* m, void* s, int B, int Lq,
                     int Lk, int H, long long qbs, long long qrs, long long kbs,
                     long long krs, long long vbs, long long vrs, float qscale,
                     void* stream) {
  if (!fwd_shape_ok(head_dim, B, Lq, Lk, H)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m);
  float* sp = static_cast<float*>(s);
  switch (dtype) {
    case 0: return fwd_dispatch<float, FwdMode::kStats>(head_dim, q, k, v, o, mp, sp, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    case 1: return fwd_dispatch<__nv_bfloat16, FwdMode::kStats>(head_dim, q, k, v, o, mp, sp, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
