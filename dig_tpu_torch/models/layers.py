"""Transformer building blocks (PyTorch), counterparts of `dig_tpu/models/layers.py`.

Parameters live in fp32 in the reference torch `state_dict` layout
(modeling_finetune.py:43-210); activations run in the module's `dtype`
(bf16 on the card by default).  Every matmul casts its input and weight to
that dtype, as flax's `nn.Dense(dtype=...)` does, so the two packages
round at the same places.  Dropout and drop-path are absent: the predict
path never runs them, and the pre-training step runs at the reference's
default drop-path rate of 0 (`PretrainConfig.drop_path`).  Gradients flow
through plain autograd, except through the kernel pairs of
`ops.attention` and `ops.layernorm`, whose backward passes are kernels too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dig_tpu_torch.ops.activations import gelu
from dig_tpu_torch.ops.attention import multi_head_attention, multi_head_attention_qkv
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


class Dense(nn.Linear):
    """`nn.Linear` with fp32 parameters that computes in `dtype`."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    """Self-attention with the reference's fused qkv projection whose bias
    is [q_bias, 0, v_bias] (modeling_finetune.py:63-125)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = qk_scale or head_dim**-0.5
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        qkv = self.qkv(x)
        if self.q_bias is not None:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = qkv + bias.to(qkv.dtype)
        # the kernels read q, k, v as column slices of the packed projection
        # and write their gradients into one [B, L, 3C] tensor the same way
        return self.proj(multi_head_attention_qkv(qkv, self.num_heads, self.scale))


class Block(nn.Module):
    """Pre-LN transformer block with optional layerscale
    (modeling_finetune.py:128-170)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 init_values: float = 0.0, ln_eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim, ln_eps, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype)
        self.norm2 = FusedLayerNorm(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        if init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x):
        a = self.attn(self.norm1(x))
        if self.gamma_1 is not None:
            a = self.gamma_1.to(a.dtype) * a
        x = x + a
        m = self.mlp(self.norm2(x))
        if self.gamma_2 is not None:
            m = self.gamma_2.to(m.dtype) * m
        return x + m


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
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

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
