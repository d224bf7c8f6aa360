"""DiG pre-training model (PyTorch): MoCo v3-style contrastive + SimMIM
pixel regression, counterpart of `dig_tpu/models/moco.py`.

Parity target: the reference `MoCo_ViT`
(modeling_pretrain_moco_mim_ori.py:261-577).  The module tree keeps its
`state_dict` layout (`encoder.`, `encoder_projection_layer.`,
`predictor.`, `patch_extractor.`, `pix_projector.`, `pix_decoder.` and the
momentum copies `momentum_encoder.`, `momentum_projection_layer.`,
`momentum_patch_extractor.`, `pix_projector_m.`), so
`dig_tpu.utils.checkpoint.convert_torch_moco` reads this model's
`state_dict()`.  Unlike the JAX package, whose momentum branch is a second
parameter tree applied to the student's module definitions, the momentum
branch here is a set of modules of its own, as in the reference: they hold
no gradients and are updated in place by `train.state.ema_update`.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dig_tpu_torch.models.layers import Conv3x3, CrossBlock, Dense, LayerNorm
from dig_tpu_torch.models.registry import register_model
from dig_tpu_torch.models.vit import PretrainViTEncoder
from dig_tpu_torch.ops.activations import gelu
from dig_tpu_torch.parallel.dist import all_reduce_sum, get_world_size


class BatchStatsNorm(nn.Module):
    """BatchNorm that always normalizes with the current batch's statistics
    over every leading axis, in at least fp32, eps 1e-5; no running
    statistics (the SSL graph never runs BN in eval mode).  `affine=False`
    drops the scale and shift (the last BN of a head).

    Across data-parallel ranks the statistics are the global batch's, with
    gradients (`parallel.dist.all_reduce_sum`): the mean first, as the sum
    over every rank's rows over their count, then the variance as the mean
    of (x - mean)^2 (`dig_tpu/models/moco.py:59-61`), never E[x^2] - E[x]^2.
    The ranks hold equal batches (the training loaders drop the last
    partial one), so the count is the local count times the world size."""

    def __init__(self, dim: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        count = xf[..., 0].numel() * get_world_size()
        mean = all_reduce_sum(xf.sum(dim=axes, keepdim=True)) / count
        var = all_reduce_sum(((xf - mean) ** 2).sum(dim=axes, keepdim=True)) / count
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y.to(x.dtype)


class MLPHead(nn.Sequential):
    """Projection / prediction head (reference `_build_mlp`, :463-482):
    per hidden layer Dense (no bias) + BN + ReLU, then Dense + affine-free
    BN.  Layer l's Dense sits at index 3l and its BN at 3l + 1, as in the
    reference's Sequential."""

    def __init__(self, num_layers: int, input_dim: int, mlp_dim: int, output_dim: int,
                 dtype=torch.float32):
        mods = []
        for layer in range(num_layers):
            last = layer == num_layers - 1
            d_in = input_dim if layer == 0 else mlp_dim
            d_out = output_dim if last else mlp_dim
            mods.append(Dense(d_in, d_out, bias=False, dtype=dtype))
            if last:
                mods.append(BatchStatsNorm(d_out, affine=False))
            else:
                mods += [BatchStatsNorm(d_out), nn.ReLU()]
        super().__init__(*mods)


def adaptive_window_pool(x: torch.Tensor, num_windows: int) -> torch.Tensor:
    """[B, gh, gw, C] -> [B, num_windows, C]: the mean over the height,
    then PyTorch's adaptive-average bins over the width (the reference's
    F.adaptive_avg_pool2d(x, (1, num_windows)), :192-193)."""
    b, gh, gw, c = x.shape
    x = x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=1).to(x.dtype)
    idx = torch.arange(gw, device=x.device)
    win = torch.arange(num_windows, device=x.device)
    lo = (win * gw) // num_windows
    hi = ((win + 1) * gw + num_windows - 1) // num_windows
    bins = ((idx[None, :] >= lo[:, None]) & (idx[None, :] < hi[:, None])).to(x.dtype)
    w = bins / bins.sum(dim=1, keepdim=True)
    return torch.einsum("wn,bnc->bwc", w, x)


class PatchNet(nn.Module):
    """Horizontal window pooling refined by `depth` cross-attention blocks
    that query the full token map, then a LayerNorm (:137-205)."""

    def __init__(self, embed_dim: int, num_heads: int, num_windows: int = 5,
                 patch_shape: Tuple[int, int] = (8, 32), depth: int = 2,
                 use_patch_transformer: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_windows = num_windows
        self.patch_shape = tuple(patch_shape)
        if use_patch_transformer:
            self.blocks = nn.ModuleList(
                CrossBlock(embed_dim, num_heads, dtype=dtype)
                for _ in range(depth))
            self.norm = LayerNorm(embed_dim, 1e-6, dtype)
        else:
            self.blocks, self.norm = None, None

    def forward(self, seq_x):
        b, n, c = seq_x.shape
        x = adaptive_window_pool(seq_x.reshape(b, *self.patch_shape, c), self.num_windows)
        if self.blocks is not None:
            for blk in self.blocks:
                x = blk(x, kv=seq_x)
            x = self.norm(x)
        return x


class _MaxPool2(nn.Module):
    """flax's `nn.max_pool(x, (2, 2), strides=(2, 2))` on [B, H, W, C]."""

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class ConvPatchNet(nn.Module):
    """`--patchnet_name conv` (`dig_tpu/models/moco.py:137-172`, reference
    modeling_pretrain_moco_mim_ori.py:207-258): four blocks of conv3x3 +
    `BatchStatsNorm` + ReLU, widths d, 1.5d, 2d, 2d, a 2x2 max-pool after
    each of the first three (8 x 32 tokens -> 1 x 4), `adaptive_window_pool`
    to `num_windows`, then Dense-BN-ReLU-Dense-BN(affine off) to one global
    vector: [B, N, d] -> [B, 1, d].  The tensors are channel-last
    throughout, so each `BatchStatsNorm` reduces over (B, H, W) as
    `BatchNorm2d` does.  Keys as the reference's: ``conv_layers.{0,2,4,6}``
    (conv ``.0``, norm ``.1``; the pools at the odd indices) and
    ``patches2global.{0,1,3,4}``, which `convert_torch_moco` reads."""

    def __init__(self, embed_dim: int, num_windows: int = 5,
                 patch_shape: Tuple[int, int] = (8, 32), dtype=torch.float32):
        super().__init__()
        d = embed_dim
        self.num_windows = num_windows
        self.patch_shape = tuple(patch_shape)
        layers, c_in = [], d
        for i, width in enumerate((d, int(d * 1.5), d * 2, d * 2)):
            layers.append(nn.Sequential(Conv3x3(c_in, width, dtype), BatchStatsNorm(width),
                                        nn.ReLU()))
            if i < 3:
                layers.append(_MaxPool2())
            c_in = width
        self.conv_layers = nn.Sequential(*layers)
        self.patches2global = nn.Sequential(
            Dense(num_windows * 2 * d, d, dtype=dtype), BatchStatsNorm(d), nn.ReLU(),
            Dense(d, d, dtype=dtype), BatchStatsNorm(d, affine=False))

    def forward(self, seq_x):
        b, n, c = seq_x.shape
        x = self.conv_layers(seq_x.reshape(b, *self.patch_shape, c))
        x = adaptive_window_pool(x, self.num_windows).reshape(b, -1)
        return self.patches2global(x)[:, None, :]


class _GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class PixDecoder(nn.Sequential):
    """Linear pixel regression head (:422-426): Dense, Dense (no biases),
    LayerNorm, GELU, Dense, at the reference's Sequential indices 0-4."""

    def __init__(self, in_dim: int, embed_dim: int = 192, num_classes: int = 48,
                 dtype=torch.float32):
        super().__init__(Dense(in_dim, embed_dim, bias=False, dtype=dtype),
                         Dense(embed_dim, embed_dim, bias=False, dtype=dtype),
                         LayerNorm(embed_dim, 1e-6, dtype), _GELU(),
                         Dense(embed_dim, num_classes, dtype=dtype))


class DiGPretrainModel(nn.Module):
    """Student and momentum modules of the DiG SSL graph.

    `forward_student(all_images, mask, generator)` -> dict(q1, q2
    [B*W, dim], pix_pred [2B, N, p*p*3]); `forward_key(all_images, mask)` ->
    (k1, k2), run on the momentum modules without gradients.
    `drop_path_rate` is the student encoder's (`--drop_path`): its masks
    are drawn from `forward_student`'s `generator`; the momentum branch
    always runs without drop-path, as `deterministic=True` makes it in the
    JAX package.  `remat` (`--remat`) rematerializes the encoder's blocks in
    the student's backward; `patchnet_name` is "regular" (`PatchNet` with
    its cross blocks), "no_patchtrans" (its pooling alone) or "conv"
    (`ConvPatchNet`), each EMA-tracked by its momentum copy."""

    def __init__(self, img_size: Tuple[int, int] = (32, 128), patch_size: int = 4,
                 encoder_embed_dim: int = 384, encoder_depth: int = 12,
                 encoder_num_heads: int = 6, decoder_num_classes: int = 48,
                 decoder_embed_dim: int = 192, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 mlp_dim: int = 4096, dim: int = 256, temperature: float = 0.2,
                 num_windows: int = 5, use_pixel_target: bool = True,
                 use_moco_target: bool = True, use_pix_projector: bool = True,
                 patchnet_name: str = "regular", label_smoothing: float = 0.0,
                 drop_path_rate: float = 0.0, remat: bool = False, dtype=torch.float32):
        super().__init__()
        self.img_size, self.patch_size = tuple(img_size), patch_size
        self.temperature, self.label_smoothing = temperature, label_smoothing
        self.use_pixel_target, self.use_moco_target = use_pixel_target, use_moco_target
        c = encoder_embed_dim
        self.encoder = PretrainViTEncoder(
            img_size, patch_size, c, encoder_depth, encoder_num_heads, mlp_ratio, qkv_bias,
            use_final_norm=not use_moco_target, drop_path_rate=drop_path_rate, remat=remat,
            dtype=dtype)
        self.has_pix_projector = use_pixel_target and use_moco_target and use_pix_projector
        if use_moco_target:
            self.encoder_projection_layer = MLPHead(3, c, mlp_dim, dim, dtype=dtype)
            self.predictor = MLPHead(2, dim, mlp_dim, dim, dtype=dtype)
            if patchnet_name == "conv":
                self.patch_extractor = ConvPatchNet(c, num_windows, self.encoder.patch_shape,
                                                    dtype)
            else:
                self.patch_extractor = PatchNet(
                    c, encoder_num_heads, num_windows, self.encoder.patch_shape,
                    use_patch_transformer=patchnet_name == "regular", dtype=dtype)
        if self.has_pix_projector:
            self.pix_projector = MLPHead(3, c, 512, c, dtype=dtype)
        if use_pixel_target:
            self.pix_decoder = PixDecoder(c, decoder_embed_dim, decoder_num_classes, dtype)
        for student, momentum in self._ema_names():
            mod = copy.deepcopy(getattr(self, student))
            mod.requires_grad_(False)
            setattr(self, momentum, mod)

    def _ema_names(self):
        """(student, momentum) module names tracked by the EMA (reference
        `_update_momentum_encoder`, :428-442)."""
        names = [("encoder", "momentum_encoder")]
        if self.use_moco_target:
            names += [("encoder_projection_layer", "momentum_projection_layer"),
                      ("patch_extractor", "momentum_patch_extractor")]
        if self.has_pix_projector:
            names.append(("pix_projector", "pix_projector_m"))
        return names

    def ema_submodules(self):
        """[(student module, momentum module), ...] for `ema_update`."""
        return [(getattr(self, s), getattr(self, m)) for s, m in self._ema_names()]

    def reset_momentum(self):
        """Make the momentum branch an exact copy of the student (the
        reference's init, :399-409), e.g. after loading student weights."""
        with torch.no_grad():
            for student, momentum in self.ema_submodules():
                momentum.load_state_dict(student.state_dict())

    @property
    def patch_shape(self):
        return self.encoder.patch_shape

    @property
    def num_patches(self):
        return self.encoder.num_patches

    def _encode(self, encoder, pix_projector, all_images, mask, generator=None):
        """Encoder trunk, then the pix projector on the first (ori) half.
        Returns (features for the contrastive branch, raw encoder output)."""
        enc = encoder(all_images, mask, generator)
        if pix_projector is None:
            return enc, enc
        b2, l, c = enc.shape
        ori, aug = enc.chunk(2, dim=0)
        projected = pix_projector(ori.reshape(-1, c)).reshape(b2 // 2, l, c)
        return torch.cat([projected, aug], dim=0), enc

    def forward_student(self, all_images, mask=None, generator=None):
        out = {}
        pix = self.pix_projector if self.has_pix_projector else None
        feats, enc_raw = self._encode(self.encoder, pix, all_images, mask, generator)
        if self.use_moco_target:
            patches = self.patch_extractor(feats)
            b2, w, c = patches.shape
            qs = self.predictor(self.encoder_projection_layer(patches.reshape(b2 * w, c)))
            q1, q2 = qs.reshape(b2, w, -1).chunk(2, dim=0)
            out["q1"] = q1.reshape(-1, q1.shape[-1])
            out["q2"] = q2.reshape(-1, q2.shape[-1])
        if self.use_pixel_target:
            # the pre-projector encoder output, as the reference feeds it (:500-510)
            out["pix_pred"] = self.pix_decoder(enc_raw)
        return out

    @torch.no_grad()
    def forward_key(self, all_images, mask=None):
        """Momentum branch: encoder -> (pix projector) -> patch extractor ->
        projection; no predictor (:525-549)."""
        pix = self.pix_projector_m if self.has_pix_projector else None
        feats, _ = self._encode(self.momentum_encoder, pix, all_images, mask)
        patches = self.momentum_patch_extractor(feats)
        b2, w, c = patches.shape
        ks = self.momentum_projection_layer(patches.reshape(b2 * w, c)).reshape(b2, w, -1)
        k1, k2 = ks.chunk(2, dim=0)
        return k1.reshape(-1, k1.shape[-1]), k2.reshape(-1, k2.shape[-1])

    def forward(self, all_images, mask=None, generator=None):
        return self.forward_student(all_images, mask, generator)


_SIZES = {"micro": (64, 2), "tiny": (192, 3), "small": (384, 6), "base": (512, 8)}
_DEPTHS = {"micro": 2}


def _pretrain(size: str, use_pixel: bool, use_moco: bool, **kwargs):
    dim, heads = _SIZES[size]
    defaults = dict(img_size=(32, 128), patch_size=4, encoder_embed_dim=dim,
                    encoder_depth=_DEPTHS.get(size, 12), encoder_num_heads=heads,
                    decoder_num_classes=48, decoder_embed_dim=192, mlp_ratio=4.0,
                    qkv_bias=True, use_pixel_target=use_pixel, use_moco_target=use_moco)
    defaults.update(kwargs)
    return DiGPretrainModel(**defaults)


for _size in _SIZES:
    for _kind, _pix, _moco in (("moco", False, True), ("simmim", True, False),
                               ("simmim_moco", True, True)):
        register_model((lambda s, p, m: lambda **kw: _pretrain(s, p, m, **kw))(_size, _pix, _moco),
                       name=f"pretrain_{_kind}_ori_vit_{_size}_patch4_32x128")


def build_pretrain_model(name: str = "pretrain_simmim_moco_ori_vit_small_patch4_32x128",
                         dtype=torch.float32, seed: int = 0, device="cuda",
                         **kwargs) -> DiGPretrainModel:
    """Build a pre-training model with random weights from `seed` (made on
    the CPU, so one seed gives the same weights on every device), the
    momentum branch an exact copy of the student, then move it to
    `device`.  `kwargs` are the model's own (mlp_dim, dim, temperature,
    num_windows, patchnet_name, label_smoothing, drop_path_rate), as
    `dig_tpu.cli.run_pretrain.build_model` passes them."""
    from dig_tpu_torch.models.rec_model import init_weights
    from dig_tpu_torch.models.registry import create_model

    model = create_model(name, dtype=dtype, **kwargs)
    if not isinstance(model, DiGPretrainModel):
        raise ValueError(f"{name!r} is not a pre-training model")
    init_weights(model, torch.Generator().manual_seed(seed))
    model.reset_momentum()
    return model.to(device).train()
