"""Multi-head attention: Hopper CUDA kernels and their plain PyTorch versions.

Counterpart of `dig_tpu/ops/attention.py`.  Layout: q/k/v are [B, L, H, D],
the natural reshape of the qkv projection; heads are never transposed to
the front.  A head-split view of a column slice of the packed qkv
[B, L, 3*H*D] keeps its batch and row strides, and the kernels read it in
place; the backward writes dq | dk | dv into the column slices of one
[B, L, 3*H*D] gradient the same way.

`multi_head_attention` (and `multi_head_attention_qkv`, the ViT's packed
entry) take the kernel pair under the JAX package's gate (`_use_pallas`:
no mask, Lq and Lk >= 128, head_dim in (32, 64) or a multiple of 128),
through an autograd Function whose forward is `attention_lse_fwd` and
whose backward is `attention_lse_bwd`, as the `jax.custom_vjp` of
`_pallas_attention_lse` pairs the two TPU kernels.  The TPU's VMEM bound
is replaced by what the CUDA kernels accept: head_dim in (32, 64, 128), a
float32 or bfloat16 input, and the shared memory of one CTA (the forward's
64 x Lk fp32 score tile, the backward's two) within 227 KB.  On the
predict path and the pre-training step that is every ViT encoder
self-attention (student and momentum branch); the decoder's masked
self-attention and cross-attention (Lq <= 25) and the window extractor's
`CrossBlock` (Lq = num_windows) take `_ref_attention`, whose gradient is
plain autograd.
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


def attention_lse_bwd_ref(q, k, v, do, m, s, scale):
    """Plain version of the backward kernel, step by step as
    `_attn_bwd_kernel_lse` (`dig_tpu/ops/attention.py:299-334`), from the
    forward's stored fp32 m, s [B, Lq, H].  Returns dq, dk, dv in the
    dtypes of q, k, v."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = q * torch.tensor(scale * _LOG2E, dtype=q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.to(acc), k.to(acc))
    e = torch.exp2(logits - m.permute(0, 2, 1)[..., None].to(acc))
    rs = 1.0 / s.to(acc)[..., None]          # [B, Lq, H, 1]
    rs_h = rs.permute(0, 2, 1, 3)            # [B, H, Lq, 1]
    dof = do.to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", e.to(v.dtype).to(acc), (dof * rs).to(v.dtype).to(acc))
    dw = torch.einsum("bqhd,bkhd->bhqk", dof.to(v.dtype).to(acc), v.to(acc))
    c = (dw * e).sum(-1, keepdim=True) * rs_h
    ds0 = (e * (dw - c)).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds0, k.to(acc)) * (scale * rs)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds0, (q.to(acc) * (scale * rs)).to(q.dtype).to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _smem_bytes(head_dim: int, lk: int) -> int:
    """Shared memory one CTA needs: mirror of `smem_bytes` in
    csrc/attention_lse_fwd.cu, which refuses more than the limit too."""
    return 4 * (_BQ * (head_dim + 1) + head_dim * (_KC + 1) + _BQ * (lk + 1) + _BQ)


def _bwd_smem_bytes(head_dim: int, lk: int) -> int:
    """Shared memory of the backward's dq pass (the larger of its two):
    mirror of `dq_smem_bytes` in csrc/attention_lse_bwd.cu."""
    return 4 * (_BQ * (head_dim + 1) + head_dim * (_KC + 1) + 2 * _BQ * (lk + 1) + 2 * _BQ)


def _fits(head_dim: int, lk: int) -> bool:
    return head_dim in _HEAD_DIMS and max(_smem_bytes(head_dim, lk),
                                          _bwd_smem_bytes(head_dim, lk)) <= _SMEM_LIMIT


def _lib():
    lib = _build.load("attention_lse_fwd")
    fn = lib.dig_attn_lse_fwd
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ll] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("attention_lse_bwd")
    fn = lib.dig_attn_lse_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 14
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_head_layout(name, t, d, what="attention_lse_fwd"):
    if t.stride(3) != 1 or t.stride(2) != d:
        raise ValueError(f"{what}: {name} must have unit stride over D and "
                         f"stride D over heads (a head-split view of [B, L, H*D] columns)")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"{what}: {name} is misaligned")


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


def attention_lse_bwd(q, k, v, do, m, s, scale, out=None):
    """Kernel wrapper, same contract as `_pallas_attention_lse_bwd`: q, do
    [B, Lq, H, D], k/v [B, Lk, H, D], the forward's fp32 m, s [B, Lq, H]
    -> (dq, dk, dv).  `out` may name three head-split views to write into
    (the column slices of one packed qkv gradient).  A CPU tensor takes
    `attention_lse_bwd_ref`; a CUDA tensor launches
    `csrc/attention_lse_bwd.cu` (two passes: dq, then dk and dv) or raises."""
    if q.device.type == "cpu":
        grads = attention_lse_bwd_ref(q, k, v, do, m, s, scale)
        if out is None:
            return grads
        for o, g in zip(out, grads):
            o.copy_(g)
        return out
    what = "attention_lse_bwd"
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype == do.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d) or do.shape != q.shape:
        raise ValueError(f"{what}: shapes {q.shape}, {k.shape}, {v.shape}, {do.shape}")
    if not _fits(d, lk):
        raise ValueError(f"{what}: head_dim {d} / Lk {lk} not supported")
    for t in (m, s):
        if t.shape != (b, lq, h) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: m and s must be contiguous fp32 [B, Lq, H]")
    if out is None:
        out = (torch.empty_like(q, memory_format=torch.contiguous_format),
               torch.empty_like(k, memory_format=torch.contiguous_format),
               torch.empty_like(v, memory_format=torch.contiguous_format))
    dq, dk, dv = out
    for name, t, ref in (("q", q, q), ("k", k, k), ("v", v, v), ("do", do, q),
                         ("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} has shape {t.shape} / dtype {t.dtype}")
        _check_head_layout(name, t, d, what)
    c = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)  # rowsum(dw * e) / s
    qscale = torch.tensor(scale * _LOG2E, dtype=q.dtype).item()
    strides = [x for t in (q, k, v, do, dq, dk, dv) for x in (t.stride(0), t.stride(1))]
    lib = _bwd_lib()
    code = lib.dig_attn_lse_bwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), s.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), c.data_ptr(),
        b, lq, lk, h, *strides, qscale, float(scale), _build.stream_ptr(q))
    _build.check(lib, code, what)
    attention_lse_bwd.launches += 1
    return dq, dk, dv


attention_lse_bwd.launches = 0


class _LSEAttention(torch.autograd.Function):
    """q, k, v [B, L, H, D] -> o, with the kernel pair's backward (the
    `jax.custom_vjp` at `dig_tpu/ops/attention.py:367-414`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, m, s = attention_lse_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, m, s)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, m, s = ctx.saved_tensors
        return (*attention_lse_bwd(q, k, v, do.contiguous(), m, s, ctx.scale), None)


def _split_heads(qkv, num_heads):
    """Head-split views [B, L, H, D] of the q, k, v column slices of [B, L, 3C]."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    return tuple(qkv[..., i * c:(i + 1) * c].view(b, l, num_heads, c // num_heads)
                 for i in range(3))


class _LSEAttentionQKV(torch.autograd.Function):
    """The same on the packed projection qkv [B, L, 3C]: the backward
    writes dq | dk | dv into the column slices of one [B, L, 3C] gradient,
    so autograd never zero-fills and sums three slice gradients."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        o, m, s = attention_lse_fwd(*_split_heads(qkv, num_heads), scale)
        ctx.save_for_backward(qkv, m, s)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, m, s = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        attention_lse_bwd(*_split_heads(qkv, ctx.num_heads), do.contiguous(), m, s, ctx.scale,
                          out=_split_heads(dqkv, ctx.num_heads))
        return dqkv, None, None


def _use_kernel(q, k, mask) -> bool:
    if mask is not None:
        return False
    _, lq, _, d = q.shape
    lk = k.shape[1]
    # short queries (the decoder's) are plain tensor ops, as on the TPU
    if lq < 128 or lk < 128:
        return False
    # the JAX gate's head_dim in (32, 64) or % 128 == 0, narrowed to what
    # the kernels are instantiated for and what their tiles fit
    return q.dtype in _DTYPES and _fits(d, lk)


def multi_head_attention(q, k, v, mask=None, scale=None):
    """Batched MHA core on [B, L, H, D]; optional boolean mask
    broadcastable to [B, H, Lq, Lk] (True = attend).  Returns [B, Lq, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _use_kernel(q, k, mask):
        return _LSEAttention.apply(q, k, v, scale)
    return _ref_attention(q, k, v, mask, scale)


def multi_head_attention_qkv(qkv, num_heads: int, scale=None):
    """Self-attention on the packed projection qkv [B, L, 3*H*D] (the ViT
    `Attention`'s call); returns [B, L, H*D]."""
    b, l, c3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _use_kernel(q, k, None):
        out = _LSEAttentionQKV.apply(qkv, num_heads, scale)
    else:
        out = _ref_attention(q, k, v, None, scale)
    return out.reshape(b, l, c3 // 3)
