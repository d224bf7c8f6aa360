// Multi-head attention forward that stores no row statistics, for Hopper
// (sm_90a), plain C interface.
//
// Replaces dig_tpu/ops/attention.py::_attn_kernel (the Pallas kernel
// called from _pallas_attention_fwd_impl), the forward of the pair that
// DIG_TPU_ATTN_STORE_LSE=0 selects: the kernel of attention_fwd.cuh with
// m and s kept in registers and shared memory and never written, in two
// modes:
//  * kPlain: exp2 of the fp32 centred logits; the sum over the fp32 e's,
//    e rounded to v's dtype for the second product (fp32 and bf16);
//  * kBf16Exp (DIG_TPU_ATTN_BF16_EXP=1, bf16 only, as the TPU kernel takes
//    it when v is bf16): e = exp2 of the centred logit rounded to bf16,
//    itself a bf16 value, and the denominator is the fp32 sum of those
//    bf16 e's, as the TPU kernel carries it in a ones-column appended to v.
// Its output equals the stored-statistics forward's (attention_lse_fwd.cu)
// bit for bit in kPlain mode: the same kernel, the same sums.
//
// Bound: at the pre-training shapes (B = 256 sequences, L = 256, H = 6,
// D = 64, bf16) the function reads q, k, v and writes o, 4 x 50.3 MB ~
// 201 MB, ~0.06 ms at 3.35 TB/s, against 2 products of 2*B*H*L*L*D =
// 25.8 GFLOP, ~0.026 ms on the bf16 tensor cores: bytes bound it.  Like the
// stored-statistics kernel it runs its products as fp32 FMAs from shared
// memory, so the FMA pipes bound it (>= 0.38 ms at 67 TFLOP/s).

#include "attention_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); bf16_exp != 0
// selects the bf16-exponential mode and needs dtype 1.  Element (b, l, h,
// d) of q is at q[b * qbs + l * qrs + h * head_dim + d] (same for k, v);
// o is contiguous [B, Lq, H, head_dim].
int dig_attn_fwd(int dtype, int head_dim, int bf16_exp, const void* q, const void* k,
                 const void* v, void* o, int B, int Lq, int Lk, int H, long long qbs,
                 long long qrs, long long kbs, long long krs, long long vbs, long long vrs,
                 float qscale, void* stream) {
  if (!fwd_shape_ok(head_dim, B, Lq, Lk, H)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (bf16_exp) return cudaErrorInvalidValue;
      return fwd_dispatch<float, FwdMode::kPlain>(head_dim, q, k, v, o, nullptr, nullptr, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    case 1:
      if (bf16_exp)
        return fwd_dispatch<__nv_bfloat16, FwdMode::kBf16Exp>(head_dim, q, k, v, o, nullptr, nullptr, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
      return fwd_dispatch<__nv_bfloat16, FwdMode::kPlain>(head_dim, q, k, v, o, nullptr, nullptr, B, Lq, Lk, H, qbs, qrs, kbs, krs, vbs, vrs, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* dig_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
