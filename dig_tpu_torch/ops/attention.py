"""Multi-head attention: a Hopper CUDA kernel and its plain PyTorch versions.

Counterpart of `dig_tpu/ops/attention.py`.  Layout: q/k/v are [B, L, H, D],
the natural reshape of the qkv projection; heads are never transposed to
the front.  A head-split view of a column slice of the packed qkv
[B, L, 3*H*D] keeps its batch and row strides, and the kernel reads it in
place.

`multi_head_attention` takes the kernel under the JAX package's gate
(`_use_pallas`: no mask, Lq and Lk >= 128, head_dim in (32, 64) or a
multiple of 128).  The TPU's VMEM bound is replaced by what the CUDA kernel
accepts: head_dim in (32, 64, 128), a float32 or bfloat16 input,
and the CTA's shared memory (a 64 x Lk fp32 score tile) within 227 KB.
On the predict path that is the ViT's self-attention; the decoder's
masked self-attention and its cross-attention (Lq <= 25) take
`_ref_attention`.
"""

from __future__ import annotations

import ctypes

import torch

from dig_tpu_torch.ops import _build

_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 CTA may use
_BQ, _KC = 64, 64     # query rows per CTA, keys per staged chunk (see the .cu)


def _ref_attention(q, k, v, mask, scale):
    """[B, Lq, H, D] x [B, Lk, H, D] plain attention with an at-least-fp32
    softmax (`dig_tpu/ops/attention.py:49-59`); mask broadcastable to
    [B, H, Lq, Lk], True = attend."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).to(acc)
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=acc, device=logits.device))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def attention_lse_fwd_ref(q, k, v, scale):
    """Plain version of the kernel, step by step as `_attn_kernel_lse`
    (`dig_tpu/ops/attention.py:275-296`).  Returns o [B, Lq, H, D] in q's
    dtype and fp32 m, s [B, Lq, H] (log2 domain)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = q * torch.tensor(scale * _LOG2E, dtype=q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.to(acc), k.to(acc))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp2(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).to(acc), v.to(acc))
    o = (o / s.permute(0, 2, 1, 3)).to(q.dtype)
    m = m[..., 0].permute(0, 2, 1).to(torch.float32)
    s = s[..., 0].permute(0, 2, 1).to(torch.float32)
    return o, m, s


def _smem_bytes(head_dim: int, lk: int) -> int:
    """Shared memory one CTA needs: mirror of `smem_bytes` in
    csrc/attention_lse_fwd.cu, which refuses more than the limit too."""
    return 4 * (_BQ * (head_dim + 1) + head_dim * (_KC + 1) + _BQ * (lk + 1) + _BQ)


def _lib():
    lib = _build.load("attention_lse_fwd")
    fn = lib.dig_attn_lse_fwd
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ll] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_head_layout(name, t, d):
    if t.stride(3) != 1 or t.stride(2) != d:
        raise ValueError(f"attention_lse_fwd: {name} must have unit stride over D and "
                         f"stride D over heads (a head-split view of [B, L, H*D] columns)")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"attention_lse_fwd: {name} is misaligned")


def attention_lse_fwd(q, k, v, scale):
    """Kernel wrapper, same contract as `_pallas_attention_lse_fwd_impl`:
    q [B, Lq, H, D], k/v [B, Lk, H, D] -> (o [B, Lq, H, D], m, s [B, Lq, H]
    fp32).  A CPU tensor takes `attention_lse_fwd_ref`; a CUDA tensor
    launches `csrc/attention_lse_fwd.cu` or raises."""
    if q.device.type == "cpu":
        return attention_lse_fwd_ref(q, k, v, scale)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attention_lse_fwd: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d):
        raise ValueError(f"attention_lse_fwd: shapes {q.shape}, {k.shape}, {v.shape}")
    if d not in _HEAD_DIMS or _smem_bytes(d, lk) > _SMEM_LIMIT:
        raise ValueError(f"attention_lse_fwd: head_dim {d} / Lk {lk} not supported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_head_layout(name, t, d)
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    s = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    # the scale is folded into q in q's dtype, as the TPU kernel does
    qscale = torch.tensor(scale * _LOG2E, dtype=q.dtype).item()
    lib = _lib()
    code = lib.dig_attn_lse_fwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), m.data_ptr(), s.data_ptr(), b, lq, lk, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        qscale, _build.stream_ptr(q))
    _build.check(lib, code, "attention_lse_fwd")
    attention_lse_fwd.launches += 1
    return o, m, s


attention_lse_fwd.launches = 0


def _use_kernel(q, k, mask) -> bool:
    if mask is not None:
        return False
    _, lq, _, d = q.shape
    lk = k.shape[1]
    # short queries (the decoder's) are plain tensor ops, as on the TPU
    if lq < 128 or lk < 128:
        return False
    # the JAX gate's head_dim in (32, 64) or % 128 == 0, narrowed to what
    # the kernel is instantiated for
    return d in _HEAD_DIMS and q.dtype in _DTYPES and _smem_bytes(d, lk) <= _SMEM_LIMIT


def multi_head_attention(q, k, v, mask=None, scale=None):
    """Batched MHA core on [B, L, H, D]; optional boolean mask
    broadcastable to [B, H, Lq, Lk] (True = attend).  Returns [B, Lq, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _use_kernel(q, k, mask):
        return attention_lse_fwd(q, k, v, scale)[0]
    return _ref_attention(q, k, v, mask, scale)


def multi_head_attention_packed(q, k, v, num_heads: int, mask=None, scale=None):
    """Same core on packed [B, L, H*D] tensors, e.g. column slices of a
    fused qkv projection, which reach the kernel without a copy.
    Returns [B, Lq, H*D]."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // num_heads
    out = multi_head_attention(q.view(b, lq, num_heads, d), k.view(b, lk, num_heads, d),
                               v.view(b, lk, num_heads, d), mask, scale)
    return out.reshape(b, lq, c)
