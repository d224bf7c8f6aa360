// Multi-head attention backward from the forward's stored row statistics,
// for Hopper (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/attention.py::_attn_bwd_kernel_lse (the Pallas
// kernel called from _pallas_attention_lse_bwd): the two passes of
// attention_bwd.cuh, reading the forward's fp32 m and s.
//
// Bound: at the pre-training shapes (B = 256 sequences, L = 256, H = 6,
// D = 64, bf16) the function reads q, k, v, do (4 x 50.3 MB) and m, s
// (3.1 MB) and writes dq, dk, dv (3 x 50.3 MB): ~355 MB, ~0.106 ms at
// 3.35 TB/s, against 5 products of 2*B*H*L*L*D = 6.4e10 flop, ~0.065 ms
// on the bf16 tensor cores: bytes bound it.  In bf16 every product is an
// mma.sync on the tensor cores, fed by 16-byte cp.async copies, with no
// score tile (the dq pass sweeps the keys twice) and the logits taken by
// the forward's own device function; fp32 keeps FMAs from shared memory
// (attention_bwd.cuh says what each design does and why).

#include "attention_bwd.cuh"

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
  const Strides st{qbs, qrs, kbs, krs, vbs, vrs, gbs, grs, dqbs, dqrs, dkbs, dkrs, dvbs, dvrs};
  // pass 1 only reads m and s in this mode
  return bwd_dispatch<false>(dtype, head_dim, q, k, v, g, static_cast<float*>(const_cast<void*>(m)),
                             static_cast<float*>(const_cast<void*>(s)), dq, dk, dv,
                             static_cast<float*>(c), B, Lq, Lk, H, st, qscale, scale,
                             static_cast<cudaStream_t>(stream));
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
