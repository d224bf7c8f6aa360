"""Recognizer: ViT encoder -> linear_norm bridge -> transformer decoder.

Counterpart of `dig_tpu/models/rec_model.py::RecModel` for
``model_kind="rec"`` (reference: models/model_builder.py:74-202).  The
module tree follows the reference `state_dict` layout (`encoder.*`,
`linear_norm.{0,1}.*`, `decoder.*`), so a `torch.save` of
`RecModel.state_dict()` loads into the JAX package through
`convert_torch_recognizer`, and a reference `.pth` loads here.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dig_tpu_torch.models.decoder import TFDecoder, create_decoder
from dig_tpu_torch.models.layers import Dense, LayerNorm, PatchEmbed, training_generator
from dig_tpu_torch.models.registry import create_model


class LinearNorm(nn.Sequential):
    """Dense + LayerNorm into the decoder width (models/model_builder.py:85-88);
    the LayerNorm has flax's eps, 1e-6."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32):
        super().__init__(Dense(in_dim, out_dim, dtype=dtype), LayerNorm(out_dim, 1e-6, dtype))


class RecModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: TFDecoder, use_1d_attdec: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.linear_norm = LinearNorm(encoder.embed_dim, decoder.d_embedding, dtype)
        self.decoder = decoder
        self.use_1d_attdec = use_1d_attdec

    def _raw_encode(self, images, generator=None):
        enc = self.encoder(images, generator)
        if self.use_1d_attdec:
            b, n, c = enc.shape
            gh, gw = self.encoder.patch_shape
            enc = enc.reshape(b, gh, gw, c).mean(dim=1)
        return enc

    def forward(self, images, targets, tgt_lens, deterministic: bool = False, generator=None):
        """Teacher-forced pass -> [B, T, num_classes] logits
        (`dig_tpu/models/rec_model.py:88-99`).  A training pass
        (`deterministic=False`) draws the dropout and drop-path masks of
        the encoder and the decoder from `generator`."""
        generator = training_generator(deterministic, generator)
        enc = self._raw_encode(images, generator)
        return self.decoder(self.linear_norm(enc), targets, tgt_lens, deterministic, generator)

    @torch.no_grad()
    def recognize(self, images, beam_width: int = 0, eos: int = 94, dense: bool = False):
        """Images in [-1, 1], [B, H, W, 3] -> (probs, ids [B, T]),
        deterministic (`dig_tpu/models/rec_model.py:45-58, 109-113`).

        `beam_width` > 0: beam search with `eos` as its end symbol; probs
        is None.  Otherwise greedy: the KV-cached loop at full length (what
        the JAX package runs off the TPU; `eos` is not read), or with
        `dense` the full-prefix loop, which stops early at `eos` >= 0.
        probs: the per-step softmax [B, T, C], fp32."""
        dec_in = self.linear_norm(self._raw_encode(images))
        if beam_width > 0:
            search = self.decoder.beam_search_dense if dense else self.decoder.beam_search
            return None, search(dec_in, beam_width, eos)
        if dense:
            return self.decoder.greedy_decode_dense(dec_in, eos if eos >= 0 else None)
        return self.decoder.greedy_decode(dec_in)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init in the JAX package's distributions: truncated normal
    (std 0.02) for the encoder's dense layers, xavier-uniform for the
    patch projection, flax's lecun-normal for the other dense layers,
    N(0, 1) for the char embedding, zero biases, unit norm scales."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, Dense):
                if name.startswith("encoder."):
                    nn.init.trunc_normal_(mod.weight, std=0.02, a=-2 * 0.02, b=2 * 0.02,
                                          generator=generator)
                else:
                    # lecun_normal: truncated normal, variance 1 / fan_in
                    std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                    nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, PatchEmbed):
                w = mod.proj.weight
                fan_in, fan_out = w[0].numel(), w.shape[0]
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                nn.init.uniform_(w, -bound, bound, generator=generator)
                mod.proj.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, 0.0, 1.0, generator=generator)


def build_rec_model(model_name: str = "vit_small_patch4_32x128",
                    decoder_name: str = "tf_decoder", nb_classes: int = 97,
                    max_len: int = 25, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                    drop_path_rate: float = 0.0, use_1d_attdec: bool = False,
                    use_mean_pooling: bool = True, dtype=torch.float32,
                    model_kind: str = "rec", seed: int = 0, device="cuda") -> RecModel:
    """Build a recognizer with random weights from `seed` (made on the CPU,
    so one seed gives the same weights on every device), then move it to
    `device`.  The encoder's rates are the fine-tuning CLI's `--drop`,
    `--attn_drop_rate` and `--drop_path` (`dig_tpu/cli/run_finetune.py:54-71`);
    the decoder's dropout is 0.1, as the JAX package hard-codes it.  Only
    ``model_kind="rec"`` is ported so far."""
    if model_kind != "rec":
        raise NotImplementedError(f"model_kind {model_kind!r} is not ported yet (rec only)")
    encoder = create_model(model_name, use_mean_pooling=use_mean_pooling, drop_rate=drop_rate,
                           attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
                           dtype=dtype)
    decoder = create_decoder(decoder_name, nb_classes, max_len, dtype=dtype)
    model = RecModel(encoder, decoder, use_1d_attdec, dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
