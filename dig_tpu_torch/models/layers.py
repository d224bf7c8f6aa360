"""Transformer building blocks (PyTorch), counterparts of `dig_tpu/models/layers.py`.

Parameters live in fp32 in the reference torch `state_dict` layout
(modeling_finetune.py:43-210); activations run in the module's `dtype`
(bf16 on the card by default).  Every matmul casts its input and weight to
that dtype, as flax's `nn.Dense(dtype=...)` does, so the two packages
round at the same places.  Gradients flow through plain autograd, except
through the kernel pairs of `ops.attention` and `ops.layernorm` and, under
`DIG_TPU_FUSED_BIAS_GRAD=1`, `Mlp.fc1`'s `ops.fused_dense`, whose backward
passes are kernels too.

Dropout and drop-path follow flax's `nn.Dropout` and `drop_path`: a
training pass draws its masks from an explicit `torch.Generator` handed
down through `forward`; without one (`generator=None`) the pass is
deterministic.  Nothing here draws from torch's global RNG.  Attention
dropout takes the unfused path (`attention_with_dropout`), as in the JAX
package, so a training pass with `attn_drop > 0` launches no attention
kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dig_tpu_torch.ops.activations import gelu
from dig_tpu_torch.ops.attention import (
    split_heads,
    multi_head_attention,
    multi_head_attention_qkv,
)
from dig_tpu_torch.ops.fused_dense import fused_bias_grad_enabled, fused_dense
from dig_tpu_torch.ops.layernorm import layer_norm as fused_layer_norm


def sinusoid_position_table(n_position: int, dim: int) -> np.ndarray:
    """[1, n_position, dim] fixed sin/cos table (not a parameter)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(dim, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / dim)
    table = np.zeros((n_position, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None].astype(np.float32)


def make_causal_mask(length: int, device=None) -> torch.Tensor:
    """[1, L, L] boolean lower-triangular mask (True = attend)."""
    return torch.tril(torch.ones((length, length), dtype=torch.bool, device=device))[None]


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, 1, L] boolean mask, True where position < length."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None])[:, None, :]


def training_generator(deterministic: bool, generator: Optional[torch.Generator]):
    """The generator a pass draws its dropout masks from: None for a
    deterministic pass; a training pass needs an explicit one."""
    if deterministic:
        return None
    if generator is None:
        raise ValueError("a training pass (deterministic=False) draws its dropout masks from an "
                         "explicit torch.Generator: pass generator=")
    return generator


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """flax `nn.Dropout`: with a generator each element is kept with
    probability 1 - rate and scaled to x / (1 - rate); without one, x."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x, rate: float, generator: Optional[torch.Generator]):
    """Stochastic depth (`dig_tpu/models/layers.py:51-58`): one keep draw
    per sample drops its whole residual branch or scales it by 1 / keep."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attention_with_dropout(q, k, v, mask, scale: float, rate: float,
                           generator: torch.Generator):
    """The unfused attention that dropout on the weights forces
    (`dig_tpu/models/layers.py:148-159`, `models/decoder.py:83-90`): fp32
    softmax of the masked logits, cast to v's dtype, dropout, second
    product.  q [B, Lq, H, D], k/v [B, Lk, H, D] -> [B, Lq, H, D]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    if mask is not None:
        # a scalar fill: a tensor made from a host value would wait for the card
        logits = logits.masked_fill(~mask, -1e30)
    weights = dropout(torch.softmax(logits, dim=-1).to(v.dtype), rate, generator)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class _EmbeddingRows(torch.autograd.Function):
    """weight[ids], whose backward sums each row's gradients in a one-hot
    product: torch's CUDA embedding backward (sorted above 3,072 ids) gives
    other bits from run to run, seen on an NVIDIA H100 by chip_smoke.py, and
    a resumed run must repeat an uninterrupted one bit for bit."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        onehot = F.one_hot(ids.reshape(-1), ctx.num_rows).to(grad.dtype)
        return onehot.t() @ grad.reshape(-1, grad.shape[-1]), None


def embedding(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` of `weight` ([..., D]), with a reproducible backward."""
    return _EmbeddingRows.apply(weight, ids)


class Dense(nn.Linear):
    """`nn.Linear` with fp32 parameters that computes in `dtype`."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _exact_conv(dtype):
    """The convolution backend for a call, reproducible and exact for its
    type: in fp32 PyTorch's own im2col + GEMM (cuDNN off), whose fp32 sums
    are those of a matrix product (on an H100 its forward and weight
    gradient lie within 1e-6 of fp64, cuDNN's deterministic algorithms' at
    3e-6 and 4e-5, cuDNN's default TF32 at 3e-4; `chip_smoke.py`); in bf16
    cuDNN with deterministic algorithms.  TF32 off and no autotuning in
    both."""
    return torch.backends.cudnn.flags(enabled=dtype != torch.float32, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv3x3Fn(torch.autograd.Function):
    """A 3x3, stride-1, padding-1 convolution of NCHW `x`, whose forward and
    backward both run under `_exact_conv`: the global cuDNN flags at the
    time autograd reaches the backward would otherwise choose its
    algorithms, and cuDNN's fastest backward algorithms are not
    reproducible, which a resumed run that must repeat an uninterrupted
    one bit for bit cannot take."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        with _exact_conv(x.dtype):
            return F.conv2d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        with _exact_conv(x.dtype):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                list(ctx.needs_input_grad))
        return gx, gw, gb


class Conv3x3(nn.Conv2d):
    """flax's `nn.Conv(c_out, (3, 3), padding="SAME", dtype=dtype)` on a
    channel-last [B, H, W, C] input: fp32 parameters in torch's layout
    ([c_out, c_in, 3, 3]) cast to `dtype`, output [B, H, W, c_out].  The
    channel-last input seen as NCHW is a channels-last tensor, which cuDNN
    takes as it is."""

    def __init__(self, in_channels, out_channels, dtype=torch.float32):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = _Conv3x3Fn.apply(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt))
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm` semantics: eps 1e-6 (torch's default is 1e-5),
    at-least-fp32 statistics with the fast variance max(E[x^2] - mu^2, 0),
    output in `dtype`.  Plain tensor ops: no TPU kernel served these norms."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        return ((xf - mu) * mul + self.bias.to(acc)).to(self.compute_dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm through `ops.layernorm.layer_norm` (the CUDA kernel where
    the shape passes its gate); output cast to `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        return fused_layer_norm(x, self.weight, self.bias, self.eps).to(self.compute_dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 -> dropout (`dig_tpu/models/layers.py:77-102`).
    Under `DIG_TPU_FUSED_BIAS_GRAD=1`, decided at every call as the JAX
    package decides it, fc1's parameters go through `FusedBiasGradDense`."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)
        self.dropout = dropout

    def forward(self, x, generator=None):
        fc1 = self.fc1
        if fused_bias_grad_enabled():
            h = fused_dense(x, fc1.weight, fc1.bias, fc1.compute_dtype)
        else:
            h = fc1(x)
        return dropout(self.fc2(gelu(h)), self.dropout, generator)


class Attention(nn.Module):
    """Self-attention with the reference's fused qkv projection whose bias
    is [q_bias, 0, v_bias] (modeling_finetune.py:63-125)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        head_dim = dim // num_heads
        self.scale = qk_scale or head_dim**-0.5
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, generator=None):
        qkv = self.qkv(x)
        if self.q_bias is not None:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = qkv + bias.to(qkv.dtype)
        if self.attn_drop > 0.0 and generator is not None:
            b, n, c3 = qkv.shape
            out = attention_with_dropout(*split_heads(qkv, self.num_heads), None, self.scale,
                                         self.attn_drop, generator).reshape(b, n, c3 // 3)
        else:
            # the kernels read q, k, v as column slices of the packed projection
            # and write their gradients into one [B, L, 3C] tensor the same way
            out = multi_head_attention_qkv(qkv, self.num_heads, self.scale)
        return dropout(self.proj(out), self.proj_drop, generator)


class Block(nn.Module):
    """Pre-LN transformer block with optional layerscale and drop-path
    (modeling_finetune.py:128-170); `drop` is the rate of the projection's
    and the Mlp's dropout."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 init_values: float = 0.0, ln_eps: float = 1e-6, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim, ln_eps, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, attn_drop, drop, dtype)
        self.norm2 = FusedLayerNorm(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype)
        self.drop_path_rate = drop_path_rate
        if init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x, generator=None):
        a = self.attn(self.norm1(x), generator)
        if self.gamma_1 is not None:
            a = self.gamma_1.to(a.dtype) * a
        x = x + drop_path(a, self.drop_path_rate, generator)
        m = self.mlp(self.norm2(x), generator)
        if self.gamma_2 is not None:
            m = self.gamma_2.to(m.dtype) * m
        return x + drop_path(m, self.drop_path_rate, generator)


class CrossAttention(nn.Module):
    """Attention of a few queries over an external token map, with the
    reference's separate q/k/v projections, without biases as the window
    extractor builds them (modeling_pretrain_moco_mim_ori.py:21-135)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.linear_q = Dense(dim, dim, bias=False, dtype=dtype)
        self.linear_k = Dense(dim, dim, bias=False, dtype=dtype)
        self.linear_v = Dense(dim, dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, xq, kv):
        b, lq, c = xq.shape
        lk = kv.shape[1]
        q, k, v = self.linear_q(xq), self.linear_k(kv), self.linear_v(kv)
        h = self.num_heads
        out = multi_head_attention(q.view(b, lq, h, c // h), k.view(b, lk, h, c // h),
                                   v.view(b, lk, h, c // h))
        return self.proj(out.reshape(b, lq, c))


class CrossBlock(nn.Module):
    """Pre-LN block whose attention takes external k/v, for the window
    patch extractor (`dig_tpu/models/layers.py:222-265`).  As in the
    reference, one `norm1` normalizes q and kv alike, and the residual is
    added onto the *normalized* q.  Its norms are plain flax-semantics
    `LayerNorm`s (no TPU kernel served them); with Lq = num_windows its
    attention takes `_ref_attention`."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_eps, dtype)
        self.attn = CrossAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, kv=None):
        xq = self.norm1(x)
        x = xq + self.attn(xq, xq if kv is None else self.norm1(kv))
        return x + self.mlp(self.norm2(x))


class _PatchProj(nn.Module):
    """Holds the patch projection in the reference conv layout:
    weight [D, C, p, p], bias [D]."""

    def __init__(self, embed_dim: int, in_chans: int, patch_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as reshape + matmul on NHWC input.

    The weight keeps the reference conv layout [D, C, p, p]
    (modeling_finetune.py:188); each patch is flattened in that (c, p, p)
    order and multiplied by the weight viewed as [D, C*p*p].  No
    `nn.Conv2d`: cuDNN would run an fp32 convolution in TF32."""

    def __init__(self, img_size=(32, 128), patch_size: int = 4, in_chans: int = 3,
                 embed_dim: int = 384, dtype=torch.float32):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.proj = _PatchProj(embed_dim, in_chans, patch_size)
        self.compute_dtype = dtype

    @property
    def patch_shape(self):
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self):
        gh, gw = self.patch_shape
        return gh * gw

    def forward(self, x):
        b, h, w, c = x.shape
        if (h, w) != self.img_size:
            raise ValueError(f"Input image size ({h}*{w}) doesn't match model "
                             f"({self.img_size[0]}*{self.img_size[1]}).")
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, gh * gw, c * p * p)
        dt = self.compute_dtype
        weight = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return F.linear(x.to(dt), weight.to(dt), self.proj.bias.to(dt))
