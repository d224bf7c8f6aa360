// Multi-head attention backward that recomputes the row statistics, for
// Hopper (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/attention.py::_attn_bwd_kernel (the Pallas kernel
// called from _pallas_attention_bwd), the backward of the pair that
// DIG_TPU_ATTN_STORE_LSE=0 selects, whose forward stores nothing: the two
// passes of attention_bwd.cuh in their kRecompute mode.  The dq pass takes
// the row max m and exp2-sum s itself before its other sweeps, from the
// forward kernel's logits (the same device function in bf16, the same FMA
// order in fp32) and in the forward kernel's order, and writes them with c
// to an fp32 scratch the wrapper allocates; the dk/dv pass reads them back.
// No float atomics: the result does not change from run to run, and it is
// bitwise the stored-statistics backward's (attention_lse_bwd.cu) on the
// same inputs, in both dtypes.  Like the TPU kernel it has no
// bf16-exponential branch: it recomputes in fp32 whatever the forward did.
//
// Bound: at the pre-training shapes (B = 256 sequences, L = 256, H = 6,
// D = 64, bf16) the function reads q, k, v, do (4 x 50.3 MB) and writes
// dq, dk, dv (3 x 50.3 MB): ~352 MB, ~0.105 ms at 3.35 TB/s, against 5
// products of 2*B*H*L*L*D = 6.4e10 flop, ~0.065 ms on the bf16 tensor
// cores: bytes bound it.  In bf16 every product is a wgmma on tiles that
// TMA brings into shared memory, in two warp-specialised persistent passes;
// fp32 keeps FMAs from shared memory (attention_bwd.cuh).

#include "attention_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the three gradients
// alike).  Element (b, l, h, d) of q is at q[b * qbs + l * qrs + h * head_dim
// + d], and likewise for k, v, do (g*), dq, dk and dv with their own batch
// and row strides; m, s and c are contiguous fp32 [B, Lq, H] scratch.
// qscale is scale * log2(e) rounded to the input dtype, as the forward
// kernel takes it.
int dig_attn_bwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                 const void* g, void* m, void* s, void* dq, void* dk, void* dv, void* c,
                 int B, int Lq, int Lk, int H, long long qbs, long long qrs, long long kbs,
                 long long krs, long long vbs, long long vrs, long long gbs, long long grs,
                 long long dqbs, long long dqrs, long long dkbs, long long dkrs,
                 long long dvbs, long long dvrs, float qscale, float scale, void* stream) {
  const Strides st{qbs, qrs, kbs, krs, vbs, vrs, gbs, grs, dqbs, dqrs, dkbs, dkrs, dvbs, dvrs};
  return bwd_dispatch<true>(dtype, head_dim, q, k, v, g, static_cast<float*>(m),
                            static_cast<float*>(s), dq, dk, dv, static_cast<float*>(c), B,
                            Lq, Lk, H, st, qscale, scale, static_cast<cudaStream_t>(stream));
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
