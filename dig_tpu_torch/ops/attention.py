"""Multi-head attention: Hopper CUDA kernels and their plain PyTorch versions.

Counterpart of `dig_tpu/ops/attention.py`.  Layout: q/k/v are [B, L, H, D],
the natural reshape of the qkv projection; heads are never transposed to
the front.  A head-split view of a column slice of the packed qkv
[B, L, 3*H*D] keeps its batch and row strides, and the kernels read it in
place; the backward writes dq | dk | dv into the column slices of one
[B, L, 3*H*D] gradient the same way.

`multi_head_attention` (and `multi_head_attention_qkv`, the ViT's packed
entry) take a kernel pair under the JAX package's gate (`_use_pallas`:
no mask, Lq and Lk >= 128, head_dim in (32, 64) or a multiple of 128),
through an autograd Function, as the `jax.custom_vjp`s pair the TPU
kernels.  `_kernel_fn` picks the pair at every call, as the JAX package
picks it at trace time (`DIG_TPU_ATTN_STORE_LSE`, default "1"):

* the stored-statistics pair (default): `attention_lse_fwd`, which also
  writes each row's max m and exp2-sum s, and `attention_lse_bwd`, which
  reads them;
* the recompute pair (`DIG_TPU_ATTN_STORE_LSE=0`): `attention_fwd`, which
  stores nothing, and `attention_bwd`, which takes m and s again from the
  logits.  Its forward has the bf16-exponential branch (`BF16_EXP`, read
  from `DIG_TPU_ATTN_BF16_EXP` at import, for bf16 inputs); its backward,
  like the TPU kernel's, recomputes in fp32 either way.  `BF16_EXP` does
  nothing under the default pair, as in the JAX package.

The TPU's VMEM bound is replaced by what the CUDA kernels accept: head_dim
in (32, 64, 128), a float32 or bfloat16 input, and the shared memory of
one CTA of the FMA bodies (the fp32 forward's 64 x Lk score tile, the
backward's two) within 227 KB; the bf16 forward and backward run on the
tensor cores with no score tile, under the same Lk limit, and need 16-byte
aligned rows (operands and gradients alike).  The TPU block-size knobs (`DIG_TPU_ATTN_ROWS`,
`DIG_TPU_ATTN_BWD_ROWS`, `DIG_TPU_ATTN_PARALLEL`) size Pallas grids and
have no counterpart here.  On the predict path and the pre-training step
the pair serves every ViT encoder self-attention (student and momentum
branch); the decoder's masked self-attention and cross-attention
(Lq <= 25), the window extractor's `CrossBlock` (Lq = num_windows) and
attention under dropout take `_ref_attention` or the dropout path of
`models.layers`, whose gradients are plain autograd.
"""

from __future__ import annotations

import ctypes
import os

import torch

from dig_tpu_torch.ops import _build

_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 CTA may use
_BQ, _KC = 64, 64     # query rows per CTA, keys per staged chunk (see the .cuh)

# bf16 exponentials in the recompute forward (`dig_tpu/ops/attention.py:46`);
# tests may assign it
BF16_EXP = os.environ.get("DIG_TPU_ATTN_BF16_EXP", "0") == "1"


def _ref_attention(q, k, v, mask, scale):
    """[B, Lq, H, D] x [B, Lk, H, D] plain attention with an at-least-fp32
    softmax (`dig_tpu/ops/attention.py:49-59`); mask broadcastable to
    [B, H, Lq, Lk], True = attend."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).to(acc)
    if mask is not None:
        # a scalar fill: a tensor made from a host value would wait for the card
        logits = logits.masked_fill(~mask, -1e30)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def _logits(q, k, scale, acc):
    """[B, H, Lq, Lk] log2-domain logits: q scaled by scale * log2(e) in
    q's dtype, products summed in `acc`, as the TPU kernels take them."""
    qs = q * torch.tensor(scale * _LOG2E, dtype=q.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", qs.to(acc), k.to(acc))


def attention_lse_fwd_ref(q, k, v, scale):
    """Plain version of the kernel, step by step as `_attn_kernel_lse`
    (`dig_tpu/ops/attention.py:275-296`).  Returns o [B, Lq, H, D] in q's
    dtype and fp32 m, s [B, Lq, H] (log2 domain)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = _logits(q, k, scale, acc)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp2(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).to(acc), v.to(acc))
    o = (o / s.permute(0, 2, 1, 3)).to(q.dtype)
    m = m[..., 0].permute(0, 2, 1).to(torch.float32)
    s = s[..., 0].permute(0, 2, 1).to(torch.float32)
    return o, m, s


def attention_fwd_ref(q, k, v, scale):
    """Plain version of the recompute forward, step by step as
    `_attn_kernel` (`dig_tpu/ops/attention.py:65-108`), including its
    `BF16_EXP` branch for bf16 v: exp2 of the centred logits rounded to
    bf16, the denominator the fp32 sum of those bf16 exponentials (the
    ones-column appended to v).  Returns o [B, Lq, H, D] in q's dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = _logits(q, k, scale, acc)
    centered = logits - logits.amax(dim=-1, keepdim=True)
    if BF16_EXP and v.dtype == torch.bfloat16:
        e = torch.exp2(centered.to(torch.bfloat16)).to(acc)
    else:
        e = torch.exp2(centered)
    s = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).to(acc), v.to(acc))
    return (o / s.permute(0, 2, 1, 3)).to(q.dtype)


def attention_lse_bwd_ref(q, k, v, do, m, s, scale):
    """Plain version of the backward kernel, step by step as
    `_attn_bwd_kernel_lse` (`dig_tpu/ops/attention.py:299-334`), from the
    forward's stored fp32 m, s [B, Lq, H].  Returns dq, dk, dv in the
    dtypes of q, k, v."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = _logits(q, k, scale, acc)
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


def attention_bwd_ref(q, k, v, do, scale):
    """Plain version of the recompute backward `_attn_bwd_kernel`
    (`dig_tpu/ops/attention.py:111-149`): the row max and exp2-sum taken
    again from the fp32 logits (:127-130), then the steps of the
    stored-statistics backward, which are its own.  No bf16-exponential
    branch, as in the TPU kernel."""
    _, m, s = attention_lse_fwd_ref(q, k, v, scale)
    return attention_lse_bwd_ref(q, k, v, do, m, s, scale)


def _smem_bytes(head_dim: int, lk: int) -> int:
    """Shared memory one CTA of the fp32 forward body needs: mirror of
    `fwd_smem_bytes` in csrc/attention_fwd.cuh, whose C entries refuse
    more than the limit too.  It sets the Lk limit of both dtypes."""
    return 4 * (_BQ * (head_dim + 1) + head_dim * (_KC + 1) + _BQ * (lk + 1) + _BQ)


def _bwd_smem_bytes(head_dim: int, lk: int) -> int:
    """Shared memory of the fp32 backward's dq pass (the larger of its
    two): mirror of `dq_smem_bytes` in csrc/attention_bwd.cuh.  It sets
    the Lk limit of both dtypes."""
    return 4 * (_BQ * (head_dim + 1) + head_dim * (_KC + 1) + 2 * _BQ * (lk + 1) + 2 * _BQ)


def _fits(head_dim: int, lk: int) -> bool:
    return head_dim in _HEAD_DIMS and max(_smem_bytes(head_dim, lk),
                                          _bwd_smem_bytes(head_dim, lk)) <= _SMEM_LIMIT


_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
# ctypes signatures of the C entries (see each source's extern "C" block)
_SIGNATURES = {
    "dig_attn_lse_fwd": [_I, _I] + [_P] * 6 + [_I] * 4 + [_LL] * 6 + [ctypes.c_float, _P],
    "dig_attn_fwd": [_I, _I, _I] + [_P] * 4 + [_I] * 4 + [_LL] * 6 + [ctypes.c_float, _P],
    "dig_attn_lse_bwd": ([_I, _I] + [_P] * 10 + [_I] * 4 + [_LL] * 14
                         + [ctypes.c_float, ctypes.c_float, _P]),
}
_SIGNATURES["dig_attn_bwd"] = _SIGNATURES["dig_attn_lse_bwd"]


def _entry(source: str, name: str):
    """The C entry `name` of `csrc/<source>.cu`, built and typed on first use."""
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_head_layout(name, t, d, what):
    if t.stride(3) != 1 or t.stride(2) != d:
        raise ValueError(f"{what}: {name} must have unit stride over D and "
                         f"stride D over heads (a head-split view of [B, L, H*D] columns)")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"{what}: {name} is misaligned")


def _check_rows_16_bytes(name, t, what):
    """The bf16 bodies move whole rows by 16-byte copies and stores; fp32
    (the FMA bodies, element by element) is exempt."""
    if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
            t.stride(i) % 8 for i in (0, 1) if t.shape[i] > 1)):
        raise ValueError(f"{what}: bf16 {name} needs a 16-byte aligned base and batch "
                         f"and row strides that are multiples of 8 elements")


def _qscale(q, scale) -> float:
    """scale * log2(e) rounded to q's dtype: the kernels fold it into q
    in q's dtype, as the TPU kernels do."""
    return torch.tensor(scale * _LOG2E, dtype=q.dtype).item()


def _fwd_checks(q, k, v, what):
    """The forward kernels' contract; returns (b, lq, lk, h, d)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d):
        raise ValueError(f"{what}: shapes {q.shape}, {k.shape}, {v.shape}")
    if d not in _HEAD_DIMS or _smem_bytes(d, lk) > _SMEM_LIMIT:
        raise ValueError(f"{what}: head_dim {d} / Lk {lk} not supported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_head_layout(name, t, d, what)
        _check_rows_16_bytes(name, t, what)
    return b, lq, lk, h, d


def _strides(*ts):
    return [x for t in ts for x in (t.stride(0), t.stride(1))]


def attention_lse_fwd(q, k, v, scale):
    """Kernel wrapper, same contract as `_pallas_attention_lse_fwd_impl`:
    q [B, Lq, H, D], k/v [B, Lk, H, D] -> (o [B, Lq, H, D], m, s [B, Lq, H]
    fp32).  A CPU tensor takes `attention_lse_fwd_ref`; a CUDA tensor
    launches `csrc/attention_lse_fwd.cu` or raises."""
    if q.device.type == "cpu":
        return attention_lse_fwd_ref(q, k, v, scale)
    what = "attention_lse_fwd"
    b, lq, lk, h, d = _fwd_checks(q, k, v, what)
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    s = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    code = _entry("attention_lse_fwd", "dig_attn_lse_fwd")(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), m.data_ptr(), s.data_ptr(), b, lq, lk, h, *_strides(q, k, v),
        _qscale(q, scale), _build.stream_ptr(q))
    _build.check(_build.load("attention_lse_fwd"), code, what)
    attention_lse_fwd.launches += 1
    return o, m, s


attention_lse_fwd.launches = 0


def attention_fwd(q, k, v, scale):
    """Kernel wrapper, same contract as `_pallas_attention_fwd_impl`:
    q [B, Lq, H, D], k/v [B, Lk, H, D] -> o [B, Lq, H, D]; no statistics
    are stored.  Under `BF16_EXP` a bf16 input takes the bf16-exponential
    mode.  A CPU tensor takes `attention_fwd_ref`; a CUDA tensor launches
    `csrc/attention_fwd.cu` or raises."""
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, scale)
    what = "attention_fwd"
    b, lq, lk, h, d = _fwd_checks(q, k, v, what)
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    bf16_exp = int(BF16_EXP and v.dtype == torch.bfloat16)
    code = _entry("attention_fwd", "dig_attn_fwd")(
        _DTYPES[q.dtype], d, bf16_exp, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), b, lq, lk, h, *_strides(q, k, v), _qscale(q, scale),
        _build.stream_ptr(q))
    _build.check(_build.load("attention_fwd"), code, what)
    attention_fwd.launches += 1
    return o


attention_fwd.launches = 0


def _bwd_checks(q, k, v, do, out, what):
    """The backward kernels' contract; allocates (dq, dk, dv) when `out`
    is None.  Returns (b, lq, lk, h, d) and the three outputs."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype == do.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d) or do.shape != q.shape:
        raise ValueError(f"{what}: shapes {q.shape}, {k.shape}, {v.shape}, {do.shape}")
    if not _fits(d, lk):
        raise ValueError(f"{what}: head_dim {d} / Lk {lk} not supported")
    if out is None:
        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))
    dq, dk, dv = out
    for name, t, ref in (("q", q, q), ("k", k, k), ("v", v, v), ("do", do, q),
                         ("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} has shape {t.shape} / dtype {t.dtype}")
        _check_head_layout(name, t, d, what)
        _check_rows_16_bytes(name, t, what)
    return (b, lq, lk, h, d), out


def _copy_into(out, grads):
    if out is None:
        return grads
    for o, g in zip(out, grads):
        o.copy_(g)
    return out


def attention_lse_bwd(q, k, v, do, m, s, scale, out=None):
    """Kernel wrapper, same contract as `_pallas_attention_lse_bwd`: q, do
    [B, Lq, H, D], k/v [B, Lk, H, D], the forward's fp32 m, s [B, Lq, H]
    -> (dq, dk, dv).  `out` may name three head-split views to write into
    (the column slices of one packed qkv gradient).  A CPU tensor takes
    `attention_lse_bwd_ref`; a CUDA tensor launches
    `csrc/attention_lse_bwd.cu` (two passes: dq, then dk and dv; bf16 on the
    tensor cores, fp32 on FMAs) or raises."""
    if q.device.type == "cpu":
        return _copy_into(out, attention_lse_bwd_ref(q, k, v, do, m, s, scale))
    what = "attention_lse_bwd"
    (b, lq, lk, h, d), (dq, dk, dv) = _bwd_checks(q, k, v, do, out, what)
    for t in (m, s):
        if t.shape != (b, lq, h) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: m and s must be contiguous fp32 [B, Lq, H]")
    c = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)  # rowsum(dw * e) / s
    code = _entry("attention_lse_bwd", "dig_attn_lse_bwd")(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), s.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), c.data_ptr(),
        b, lq, lk, h, *_strides(q, k, v, do, dq, dk, dv), _qscale(q, scale), float(scale),
        _build.stream_ptr(q))
    _build.check(_build.load("attention_lse_bwd"), code, what)
    attention_lse_bwd.launches += 1
    return dq, dk, dv


attention_lse_bwd.launches = 0


def attention_bwd(q, k, v, do, scale, out=None):
    """Kernel wrapper, same contract as `_pallas_attention_bwd`: q, do
    [B, Lq, H, D], k/v [B, Lk, H, D] -> (dq, dk, dv), recomputing the row
    statistics.  `out` as for `attention_lse_bwd`.  A CPU tensor takes
    `attention_bwd_ref`; a CUDA tensor launches `csrc/attention_bwd.cu`
    (two passes: dq, m, s and c, then dk and dv) or raises."""
    if q.device.type == "cpu":
        return _copy_into(out, attention_bwd_ref(q, k, v, do, scale))
    what = "attention_bwd"
    (b, lq, lk, h, d), (dq, dk, dv) = _bwd_checks(q, k, v, do, out, what)
    m, s, c = torch.empty((3, b, lq, h), dtype=torch.float32, device=q.device)  # pass 1 -> pass 2
    code = _entry("attention_bwd", "dig_attn_bwd")(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), s.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), c.data_ptr(),
        b, lq, lk, h, *_strides(q, k, v, do, dq, dk, dv), _qscale(q, scale), float(scale),
        _build.stream_ptr(q))
    _build.check(_build.load("attention_bwd"), code, what)
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class _LSEAttention(torch.autograd.Function):
    """q, k, v [B, L, H, D] -> o, with the stored-statistics pair (the
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


class _Attention(torch.autograd.Function):
    """q, k, v [B, L, H, D] -> o, with the recompute pair (the
    `jax.custom_vjp` at `dig_tpu/ops/attention.py:211-258`): the forward
    saves q, k and v and nothing else."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return attention_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_bwd(q, k, v, do.contiguous(), ctx.scale), None)


def split_heads(qkv, num_heads):
    """Head-split views [B, L, H, D] of the q, k, v column slices of [B, L, 3C]."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    return tuple(qkv[..., i * c:(i + 1) * c].view(b, l, num_heads, c // num_heads)
                 for i in range(3))


class _LSEAttentionQKV(torch.autograd.Function):
    """The stored-statistics pair on the packed projection qkv [B, L, 3C]:
    the backward writes dq | dk | dv into the column slices of one
    [B, L, 3C] gradient, so autograd never zero-fills and sums three slice
    gradients."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        o, m, s = attention_lse_fwd(*split_heads(qkv, num_heads), scale)
        ctx.save_for_backward(qkv, m, s)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, m, s = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        attention_lse_bwd(*split_heads(qkv, ctx.num_heads), do.contiguous(), m, s, ctx.scale,
                          out=split_heads(dqkv, ctx.num_heads))
        return dqkv, None, None


class _AttentionQKV(torch.autograd.Function):
    """The recompute pair on the packed projection qkv [B, L, 3C], with the
    packed gradient of `_LSEAttentionQKV`; the forward saves qkv only."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return attention_fwd(*split_heads(qkv, num_heads), scale)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        attention_bwd(*split_heads(qkv, ctx.num_heads), do.contiguous(), ctx.scale,
                      out=split_heads(dqkv, ctx.num_heads))
        return dqkv, None, None


def _kernel_fn(packed: bool = False):
    """The kernel pair's autograd Function, read from
    `DIG_TPU_ATTN_STORE_LSE` at every call (`dig_tpu/ops/attention.py:438-445`):
    "1" (the default) the stored-statistics pair, anything else the
    recompute pair."""
    if os.environ.get("DIG_TPU_ATTN_STORE_LSE", "1") == "1":
        return _LSEAttentionQKV if packed else _LSEAttention
    return _AttentionQKV if packed else _Attention


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
        return _kernel_fn().apply(q, k, v, scale)
    return _ref_attention(q, k, v, mask, scale)


def multi_head_attention_qkv(qkv, num_heads: int, scale=None):
    """Self-attention on the packed projection qkv [B, L, 3*H*D] (the ViT
    `Attention`'s call); returns [B, L, H*D]."""
    b, l, c3 = qkv.shape
    q, k, v = split_heads(qkv, num_heads)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _use_kernel(q, k, None):
        out = _kernel_fn(packed=True).apply(qkv, num_heads, scale)
    else:
        out = _ref_attention(q, k, v, None, scale)
    return out.reshape(b, l, c3 // 3)
