"""ViT encoders (PyTorch), counterparts of `dig_tpu/models/vit.py`:

* `VisionTransformer` on its feature-map path: [B, 32, 128, 3] images ->
  [B, 256, C] token map (modeling_finetune.py:213-366), with the
  fine-tuning recipe's dropout after the position table, per-block
  projection / Mlp dropout and attention dropout, and drop-path rates
  rising linearly over the depth.  Sequence cls tokens and memory slots
  wait for a later slice.
* `PretrainViTEncoder`, the SimMIM encoder of the pre-training step: all
  tokens kept, masked positions replaced by a learned mask token *before*
  the position table is added (modeling_pretrain_vit.py:27-111), with the
  `simmim_vit_*` registry names.

Width table (reference registry): micro=64/2h (2 layers, tests only),
tiny=192/3h, small=384/6h, base=512/8h, depth 12, patch 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from dig_tpu_torch.models.layers import (
    Block,
    LayerNorm,
    PatchEmbed,
    dropout,
    sinusoid_position_table,
)
from dig_tpu_torch.models.registry import register_model


class VisionTransformer(nn.Module):
    def __init__(self, img_size: Tuple[int, int] = (32, 128), patch_size: int = 4,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: float = 0.0, use_mean_pooling: bool = True, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim, dtype)
        self.register_buffer(
            "pos_table",
            torch.from_numpy(sinusoid_position_table(self.patch_embed.num_patches, embed_dim)),
            persistent=False)
        # drop-path rising linearly over the depth (dig_tpu/models/vit.py:123)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale, init_values,
                  drop=drop_rate, attn_drop=attn_drop_rate, drop_path_rate=dpr[i], dtype=dtype)
            for i in range(depth))
        # the feature-map path has no final norm under mean pooling
        # (modeling_finetune.py:280, :354-355)
        self.norm = None if use_mean_pooling else LayerNorm(embed_dim, 1e-6, dtype)

    @property
    def patch_shape(self):
        return self.patch_embed.patch_shape

    @property
    def depth(self):
        return len(self.blocks)

    def forward(self, x, generator=None):
        """`generator` draws the dropout and drop-path masks of a training
        pass; None is the deterministic pass."""
        x = self.patch_embed(x)
        x = dropout(x + self.pos_table.to(x.dtype), self.drop_rate, generator)
        for blk in self.blocks:
            x = blk(x, generator)
        if self.norm is not None:
            x = self.norm(x)
        return x


class PretrainViTEncoder(nn.Module):
    """[B, 32, 128, 3] images and an optional [B, N] bool mask (True =
    masked) -> [B, N, C].  `use_final_norm=False` under MoCo, whose
    `MoCo_ViT` replaces the last LayerNorm with Identity."""

    def __init__(self, img_size: Tuple[int, int] = (32, 128), patch_size: int = 4,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, init_values: float = 0.0,
                 use_final_norm: bool = True, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer(
            "pos_table",
            torch.from_numpy(sinusoid_position_table(self.patch_embed.num_patches, embed_dim)),
            persistent=False)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale, init_values, dtype=dtype)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, 1e-6, dtype) if use_final_norm else None

    @property
    def patch_shape(self):
        return self.patch_embed.patch_shape

    @property
    def num_patches(self):
        return self.patch_embed.num_patches

    def forward(self, x, mask=None):
        x = self.patch_embed(x)
        if mask is not None:
            m = mask.to(x.dtype)[..., None]
            x = x * (1.0 - m) + self.mask_token.to(x.dtype) * m
        x = x + self.pos_table.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        if self.norm is not None:
            x = self.norm(x)
        return x


_WIDTHS = {"micro": (64, 2), "tiny": (192, 3), "small": (384, 6), "base": (512, 8)}
_DEPTHS = {"micro": 2}


def _vit(size, **kwargs):
    dim, heads = _WIDTHS[size]
    defaults = dict(img_size=(32, 128), patch_size=4, embed_dim=dim,
                    depth=_DEPTHS.get(size, 12), num_heads=heads, mlp_ratio=4.0,
                    qkv_bias=True)
    defaults.update(kwargs)
    return VisionTransformer(**defaults)


@register_model(name="vit_micro_patch4_32x128")
def vit_micro_patch4_32x128(**kw):
    """2-layer, 64-dim test model (not in the reference registry)."""
    return _vit("micro", **kw)


@register_model(name="vit_tiny_patch4_32x128")
def vit_tiny_patch4_32x128(**kw):
    return _vit("tiny", **kw)


@register_model(name="vit_small_patch4_32x128")
def vit_small_patch4_32x128(**kw):
    return _vit("small", **kw)


@register_model(name="vit_base_patch4_32x128")
def vit_base_patch4_32x128(**kw):
    return _vit("base", **kw)


def _simmim_vit(size, **kwargs):
    dim, heads = _WIDTHS[size]
    defaults = dict(img_size=(32, 128), patch_size=4, embed_dim=dim,
                    depth=_DEPTHS.get(size, 12), num_heads=heads, mlp_ratio=4.0,
                    qkv_bias=True)
    defaults.update(kwargs)
    return PretrainViTEncoder(**defaults)


for _size in _WIDTHS:
    register_model((lambda s: lambda **kw: _simmim_vit(s, **kw))(_size),
                   name=f"simmim_vit_{_size}_patch4_32x128")
