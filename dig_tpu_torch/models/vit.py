"""ViT encoders (PyTorch), counterparts of `dig_tpu/models/vit.py`:

* `VisionTransformer`, the fine-tuning encoder: [B, 32, 128, 3] images ->
  [B, 256, C] token map (modeling_finetune.py:213-366), with the
  fine-tuning recipe's dropout after the position table, per-block
  projection / Mlp dropout and attention dropout, and drop-path rates
  rising linearly over the depth; or the sequence class queries
  [B, max_seq_len, C], or the pooled feature (see the class).
* `PretrainViTEncoder`, the SimMIM encoder of the pre-training step and of
  MIM fine-tuning: all tokens kept, masked positions replaced by a learned
  mask token *before* the position table is added
  (modeling_pretrain_vit.py:27-111), with the `simmim_vit_*` registry
  names and drop-path rates rising linearly over the depth.

Width table (reference registry): micro=64/2h (2 layers, tests only),
tiny=192/3h, small=384/6h, base=512/8h, depth 12, patch 4; the satrn
names are base-wide, `vit_seq_cls_base_patch4_32x128` 768/12h.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dig_tpu_torch.models.layers import (
    Block,
    Dense,
    LayerNorm,
    PatchEmbed,
    dropout,
    sinusoid_position_table,
)
from dig_tpu_torch.models.registry import register_model


def _remat_block(blk, x, generator):
    """`blk(x, generator)` under `torch.utils.checkpoint` (non-reentrant:
    the reentrant variant drops the gradients of a block none of whose
    inputs needs one): only the block's input is kept, and its forward runs
    again inside the backward.  `preserve_rng_state` covers torch's global
    generators, from which nothing here draws; the recompute must draw the
    dropout and drop-path masks that the forward drew from `generator`, so
    it starts from the generator's state before the forward and puts back
    the state it found."""
    if generator is None:
        return checkpoint(blk, x, None, use_reentrant=False, preserve_rng_state=False)
    before = generator.get_state()
    calls = []

    def run(x):
        if not calls:  # the forward
            calls.append(1)
            return blk(x, generator)
        now = generator.get_state()  # the recompute, inside the backward
        generator.set_state(before)
        try:
            return blk(x, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def run_blocks(blocks, x, generator=None, remat: bool = False):
    """The encoder's blocks in order; with `remat`, each one rematerialized
    in the backward (`nn.remat(Block)` in the JAX package,
    `dig_tpu/models/vit.py:127, 223`), where a gradient is being recorded."""
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        x = _remat_block(blk, x, generator) if remat else blk(x, generator)
    return x


class VisionTransformer(nn.Module):
    """The fine-tuning encoder (`dig_tpu/models/vit.py:36-161`).

    * `use_seq_cls_token`: `max_seq_len` learned class queries, with their
      own sinusoid table and `cls_type_emb`, go before the visual tokens,
      which get `vis_type_emb`; only the queries are returned
      [B, max_seq_len, C] (modeling_finetune.py:249-255, :335-352).
    * `num_mem_slots`: a frozen memory bank appended to the tokens before
      the position table (no gradient, no update: `requires_grad=False`),
      dropped after the blocks unless `use_mem_in_decoder`.
    * `use_learnable_pos_emb`: a learned `pos_embed` instead of the table.
    * `return_feat_map=False`: the pooled path, `fc_norm` of the token mean
      (mean pooling) or `norm` of token 0, then `head` when `num_classes`.
    * `remat`: each block rematerialized in the backward (`run_blocks`);
      the JAX module has the field and no config reaches it, here neither.
    Parameters that the JAX package creates only on the path a flag takes
    exist here only under that flag, so the two trees hold the same names."""

    def __init__(self, img_size: Tuple[int, int] = (32, 128), patch_size: int = 4,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: float = 0.0, use_learnable_pos_emb: bool = False,
                 use_mean_pooling: bool = True, return_feat_map: bool = True,
                 num_classes: int = 0, use_seq_cls_token: bool = False, max_seq_len: int = 25,
                 num_mem_slots: int = 0, use_mem_in_decoder: bool = False,
                 remat: bool = False, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.remat = remat
        self.drop_rate = drop_rate
        self.return_feat_map = return_feat_map
        self.use_mean_pooling = use_mean_pooling
        self.use_seq_cls_token = use_seq_cls_token
        self.max_seq_len = max_seq_len
        self.num_mem_slots = num_mem_slots
        self.use_mem_in_decoder = use_mem_in_decoder
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim, dtype)
        n = self.patch_embed.num_patches + num_mem_slots
        if num_mem_slots > 0:
            self.mem_bank = nn.Parameter(torch.zeros(1, num_mem_slots, embed_dim),
                                         requires_grad=False)
        if use_learnable_pos_emb:
            self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        else:
            self.register_buffer("pos_table",
                                 torch.from_numpy(sinusoid_position_table(n, embed_dim)),
                                 persistent=False)
        if use_seq_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, max_seq_len, embed_dim))
            self.cls_type_emb = nn.Parameter(torch.zeros(1, 1, embed_dim))
            self.vis_type_emb = nn.Parameter(torch.zeros(1, 1, embed_dim))
            self.register_buffer(
                "cls_pos_table",
                torch.from_numpy(sinusoid_position_table(max_seq_len, embed_dim)),
                persistent=False)
        # drop-path rising linearly over the depth (dig_tpu/models/vit.py:123)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale, init_values,
                  drop=drop_rate, attn_drop=attn_drop_rate, drop_path_rate=dpr[i], dtype=dtype)
            for i in range(depth))
        # the feature-map path has no final norm under mean pooling
        # (modeling_finetune.py:280, :354-355); the seq-cls path has none
        self.norm = self.fc_norm = self.head = None
        if not use_seq_cls_token:
            if not use_mean_pooling:
                self.norm = LayerNorm(embed_dim, 1e-6, dtype)
            elif not return_feat_map:
                self.fc_norm = LayerNorm(embed_dim, 1e-6, dtype)
            if not return_feat_map and num_classes > 0:
                self.head = Dense(embed_dim, num_classes, dtype=dtype)

    @property
    def patch_shape(self):
        return self.patch_embed.patch_shape

    @property
    def num_patches(self):
        return self.patch_embed.num_patches

    @property
    def depth(self):
        return len(self.blocks)

    def forward(self, x, generator=None):
        """`generator` draws the dropout and drop-path masks of a training
        pass; None is the deterministic pass."""
        x = self.patch_embed(x)
        b, _, c = x.shape
        if self.num_mem_slots > 0:
            mem = self.mem_bank.detach().to(x.dtype).expand(b, -1, -1)
            x = torch.cat([x, mem], dim=1)
        pos = self.pos_embed if hasattr(self, "pos_embed") else self.pos_table
        x = dropout(x + pos.to(x.dtype), self.drop_rate, generator)
        if self.use_seq_cls_token:
            cls = (self.cls_token.to(x.dtype) + self.cls_pos_table.to(x.dtype)
                   + self.cls_type_emb.to(x.dtype))
            cls = dropout(cls.expand(b, -1, -1), self.drop_rate, generator)
            x = torch.cat([cls, x + self.vis_type_emb.to(x.dtype)], dim=1)
        x = run_blocks(self.blocks, x, generator, self.remat)
        if self.num_mem_slots > 0 and not self.use_mem_in_decoder:
            x = x[:, : x.shape[1] - self.num_mem_slots]
        if self.use_seq_cls_token:
            return x[:, : self.max_seq_len]
        if self.return_feat_map:
            return x if self.norm is None else self.norm(x)
        if self.use_mean_pooling:
            x = self.fc_norm(x.mean(dim=1))
        else:
            x = self.norm(x)[:, 0]
        return x if self.head is None else self.head(x)


class PretrainViTEncoder(nn.Module):
    """[B, 32, 128, 3] images and an optional [B, N] bool mask (True =
    masked) -> [B, N, C].  `use_final_norm=False` under MoCo, whose
    `MoCo_ViT` replaces the last LayerNorm with Identity.  With
    `drop_path_rate` > 0 a pass that is given a `generator` draws its
    blocks' drop-path masks from it; without one the pass is deterministic
    (the momentum branch, evaluation).  `remat` (`--remat`) keeps only each
    block's input for the backward and runs the block again there
    (`run_blocks`), with the same masks."""

    def __init__(self, img_size: Tuple[int, int] = (32, 128), patch_size: int = 4,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, init_values: float = 0.0,
                 use_final_norm: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 use_learnable_pos_emb: bool = False, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.remat = remat
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        n = self.patch_embed.num_patches
        if use_learnable_pos_emb:
            self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        else:
            self.register_buffer("pos_table",
                                 torch.from_numpy(sinusoid_position_table(n, embed_dim)),
                                 persistent=False)
        # drop-path rising linearly over the depth (dig_tpu/models/vit.py:221)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale, init_values,
                  drop=drop_rate, attn_drop=attn_drop_rate, drop_path_rate=dpr[i], dtype=dtype)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, 1e-6, dtype) if use_final_norm else None

    @property
    def patch_shape(self):
        return self.patch_embed.patch_shape

    @property
    def num_patches(self):
        return self.patch_embed.num_patches

    @property
    def depth(self):
        return len(self.blocks)

    def forward(self, x, mask=None, generator=None):
        x = self.patch_embed(x)
        if mask is not None:
            m = mask.to(x.dtype)[..., None]
            x = x * (1.0 - m) + self.mask_token.to(x.dtype) * m
        pos = self.pos_embed if hasattr(self, "pos_embed") else self.pos_table
        x = x + pos.to(x.dtype)
        x = run_blocks(self.blocks, x, generator, self.remat)
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


@register_model(name="vit_satrn_patch4_32x128")
def vit_satrn_patch4_32x128(**kw):
    # reference: modeling_finetune.py:429-435 (512-wide, 8 heads)
    return _vit("base", **kw)


@register_model(name="vit_seq_cls_satrn_patch4_32x128")
def vit_seq_cls_satrn_patch4_32x128(**kw):
    # reference: modeling_finetune.py:437-443
    kw.setdefault("use_seq_cls_token", True)
    kw.setdefault("max_seq_len", 25)
    return _vit("base", **kw)


@register_model(name="vit_seq_cls_base_patch4_32x128")
def vit_seq_cls_base_patch4_32x128(**kw):
    # reference: modeling_finetune.py:445-451 (768-wide, 12 heads)
    kw.setdefault("use_seq_cls_token", True)
    kw.setdefault("max_seq_len", 25)
    defaults = dict(img_size=(32, 128), patch_size=4, embed_dim=768, depth=12, num_heads=12,
                    mlp_ratio=4.0, qkv_bias=True)
    defaults.update(kw)
    return VisionTransformer(**defaults)


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
