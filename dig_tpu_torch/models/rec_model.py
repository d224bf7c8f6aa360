"""Recognizers: a ViT encoder and a text head, one class per model kind.

Counterparts of `dig_tpu/models/rec_model.py` (reference:
models/model_builder.py:8-290), built by `build_rec_model`:

* ``rec``: `RecModel`, encoder -> `linear_norm` (Dense + LayerNorm into the
  decoder width) -> transformer decoder, with `use_1d_attdec` (the mean
  over the token map's height) and, for feature distillation, `feat_proj`
  (a 3-layer `MLPHead` whose batch statistics are global under torchrun);
  with the decoupled decoder, `SeqClsRecModel`, whose `MultiLabelHead`
  gives the decoder its class-query attention maps and the eval its
  character-presence logits;
* ``ctc``: `CTCRecModel`, the height mean -> fc0 -> LayerNorm -> GELU ->
  fc1 over ``nb_classes + 1`` outputs (the blank last);
* ``attn``: `AttnRecModel`, the GRU additive-attention head
  (`models/attn_decoder.py`);
* ``seq_cls``: `SeqClsTokenRecModel`, the encoder's class queries
  classified by `head`, one parallel pass at train and eval;
* ``mim_rec``: `MimRecModel`, fine-tuning on the SimMIM encoder with an
  auxiliary masked-pixel branch (`pix_encoder_to_decoder`, `pix_head`,
  optionally `mim_proj` for the masked rows).

The module trees follow the reference `state_dict` layout where it has
one (`encoder.*`, `linear_norm.{0,1}.*`, `decoder.*`), so a reference
`.pth` loads here and a `torch.save` of a `RecModel` or `AttnRecModel`
loads into the JAX package through `convert_torch_recognizer`; the heads
the reference lacks keep the JAX package's names (`fc0`, `fc1`, `head`,
`multi_label`, `feat_proj`, `pix_head`, `mim_proj`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dig_tpu_torch.models.attn_decoder import GRU, AttentionRecognitionHead
from dig_tpu_torch.models.decoder import DecoupledTFDecoder, TFDecoder, create_decoder
from dig_tpu_torch.models.layers import (
    Conv3x3,
    Dense,
    LayerNorm,
    PatchEmbed,
    training_generator,
)
from dig_tpu_torch.models.moco import MLPHead
from dig_tpu_torch.models.registry import create_model
from dig_tpu_torch.ops.activations import gelu


class LinearNorm(nn.Sequential):
    """Dense + LayerNorm into the decoder width (models/model_builder.py:85-88);
    the LayerNorm has flax's eps, 1e-6."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32):
        super().__init__(Dense(in_dim, out_dim, dtype=dtype), LayerNorm(out_dim, 1e-6, dtype))


class GELU(nn.Module):
    """The port's GELU (tanh or erf form, `ops.activations`) as a module."""

    def forward(self, x):
        return gelu(x)


def _decode(decoder, dec_in, beam_width: int, eos: int, dense: bool = False):
    """Greedy or beam decoding of a transformer decoder
    (`dig_tpu/models/rec_model.py:45-58`).  `beam_width` > 0: beam search
    with `eos` as its end symbol; probs is None.  Otherwise greedy: the
    KV-cached loop at full length (what the JAX package runs off the TPU;
    `eos` is not read), or with `dense` the full-prefix loop, which stops
    early at `eos` >= 0.  probs: the per-step softmax [B, T, C], fp32."""
    if beam_width > 0:
        search = decoder.beam_search_dense if dense else decoder.beam_search
        return None, search(dec_in, beam_width, eos)
    if dense:
        return decoder.greedy_decode_dense(dec_in, eos if eos >= 0 else None)
    return decoder.greedy_decode(dec_in)


def _height_mean(encoder, enc):
    """[B, gh * gw, C] -> [B, gw, C], the mean over the grid's height."""
    b, _, c = enc.shape
    gh, gw = encoder.patch_shape
    return enc.reshape(b, gh, gw, c).mean(dim=1)


class RecModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: TFDecoder, use_1d_attdec: bool = False,
                 use_feat_distill: bool = False, dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.linear_norm = LinearNorm(encoder.embed_dim, decoder.d_embedding, dtype)
        self.decoder = decoder
        self.use_1d_attdec = use_1d_attdec
        self.use_feat_distill = use_feat_distill
        if use_feat_distill:
            # the distillation projector (models/model_builder.py:113-115)
            c = encoder.embed_dim
            self.feat_proj = MLPHead(3, c, 4096, c, dtype=dtype)

    def _raw_encode(self, images, generator=None):
        enc = self.encoder(images, generator)
        return _height_mean(self.encoder, enc) if self.use_1d_attdec else enc

    def encode_features(self, images):
        """The bare encoder features, deterministic, with the student's
        height mean under `use_1d_attdec` (the distillation teacher;
        engine_for_finetuning.py:34-36)."""
        return self._raw_encode(images)

    def forward(self, images, targets, tgt_lens, deterministic: bool = False, generator=None):
        """Teacher-forced pass -> [B, T, num_classes] logits
        (`dig_tpu/models/rec_model.py:88-99`), and with `use_feat_distill`
        the projected features [B, L, C] too.  A training pass
        (`deterministic=False`) draws the dropout and drop-path masks of
        the encoder and the decoder from `generator`."""
        generator = training_generator(deterministic, generator)
        enc = self._raw_encode(images, generator)
        logits = self.decoder(self.linear_norm(enc), targets, tgt_lens, deterministic, generator)
        if self.use_feat_distill:
            b, l, c = enc.shape
            return logits, self.feat_proj(enc.reshape(b * l, c)).reshape(b, l, c)
        return logits

    @torch.no_grad()
    def recognize(self, images, beam_width: int = 0, eos: int = 94, dense: bool = False):
        """Images in [-1, 1], [B, H, W, 3] -> (probs, ids [B, T]),
        deterministic (`_decode`)."""
        return _decode(self.decoder, self.linear_norm(self._raw_encode(images)), beam_width,
                       eos, dense)


class CTCRecModel(nn.Module):
    def __init__(self, encoder: nn.Module, nb_classes: int = 97, d_embedding: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.fc0 = Dense(encoder.embed_dim, d_embedding, dtype=dtype)
        self.norm = LayerNorm(d_embedding, 1e-6, dtype)
        self.fc1 = Dense(d_embedding, nb_classes + 1, dtype=dtype)

    def forward(self, images, deterministic: bool = True, generator=None):
        """-> per-frame logits [B, gw, nb_classes + 1] (32 frames at 32 x 128)."""
        generator = training_generator(deterministic, generator)
        x = _height_mean(self.encoder, self.encoder(images, generator))
        return self.fc1(gelu(self.norm(self.fc0(x))))


class AttnRecModel(nn.Module):
    def __init__(self, encoder: nn.Module, nb_classes: int = 97, max_len: int = 25,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.decoder = AttentionRecognitionHead(nb_classes, encoder.embed_dim, s_dim=512,
                                                att_dim=512, max_len_labels=max_len, dtype=dtype)

    def forward(self, images, targets, tgt_lens, deterministic: bool = False, generator=None):
        generator = training_generator(deterministic, generator)
        return self.decoder(self.encoder(images, generator), targets)

    @torch.no_grad()
    def recognize(self, images, beam_width: int = 0, eos: int = 94):
        enc = self.encoder(images)
        if beam_width > 0:
            return None, self.decoder.beam_search(enc, beam_width, eos)
        return self.decoder.sample(enc)


class MimRecModel(nn.Module):
    """Fine-tuning with an auxiliary MIM pixel branch
    (models/model_builder.py:204-290; `dig_tpu/models/rec_model.py:143-198`)."""

    def __init__(self, encoder: nn.Module, decoder: TFDecoder, use_mim_proj: bool = False,
                 pix_dim: int = 192, pix_classes: int = 48, dtype=torch.float32):
        super().__init__()
        c = encoder.embed_dim
        self.encoder = encoder
        self.linear_norm = LinearNorm(c, decoder.d_embedding, dtype)
        self.decoder = decoder
        self.pix_encoder_to_decoder = Dense(c, pix_dim, bias=False, dtype=dtype)
        self.pix_head = nn.Sequential(Dense(pix_dim, pix_dim, bias=False, dtype=dtype),
                                      LayerNorm(pix_dim, 1e-6, dtype), GELU(),
                                      Dense(pix_dim, pix_classes, dtype=dtype))
        self.mim_proj = None
        if use_mim_proj:
            self.mim_proj = nn.Sequential(Dense(c, 2 * c, dtype=dtype),
                                          LayerNorm(2 * c, 1e-6, dtype), GELU(),
                                          Dense(2 * c, c, dtype=dtype), LayerNorm(c, 1e-6, dtype))

    def forward(self, images, targets, tgt_lens, mask=None, num_mim_samples: int = 0,
                deterministic: bool = False, generator=None):
        """-> {"rec_pred": [B, T, num_classes] logits, "pix_pred": [B, N,
        p*p*3] (with a mask [B, N] bool)}.  The first `num_mim_samples` rows
        go through `mim_proj` before the decoder when it exists."""
        generator = training_generator(deterministic, generator)
        enc = self.encoder(images, mask, generator)
        out, rec_in = {}, enc
        if mask is not None:
            out["pix_pred"] = self.pix_head(self.pix_encoder_to_decoder(enc))
            if self.mim_proj is not None and num_mim_samples > 0:
                rec_in = torch.cat([self.mim_proj(enc[:num_mim_samples]),
                                    enc[num_mim_samples:]], dim=0)
        out["rec_pred"] = self.decoder(self.linear_norm(rec_in), targets, tgt_lens,
                                       deterministic, generator)
        return out

    @torch.no_grad()
    def recognize(self, images, beam_width: int = 0, eos: int = 94):
        """The unmasked encoder, then `_decode`."""
        return _decode(self.decoder, self.linear_norm(self.encoder(images)), beam_width, eos)


class SeqClsTokenRecModel(nn.Module):
    """The non-autoregressive recognizer of `--use_seq_cls_token`: the
    encoder's class queries classified by `head`
    (`dig_tpu/models/rec_model.py:201-221`)."""

    def __init__(self, encoder: nn.Module, nb_classes: int = 97, dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.head = Dense(encoder.embed_dim, nb_classes, dtype=dtype)

    def forward(self, images, targets=None, tgt_lens=None, deterministic: bool = False,
                generator=None):
        generator = training_generator(deterministic, generator)
        return self.head(self.encoder(images, generator))

    @torch.no_grad()
    def recognize(self, images, beam_width: int = 0, eos: int = 94):
        """(softmax [B, T, C] fp32, its argmax) of one deterministic pass."""
        probs = torch.softmax(self(images, deterministic=True).float(), dim=-1)
        return probs, torch.argmax(probs, dim=-1)


class MultiLabelHead(nn.Module):
    """Class-query attention pooling: per-character presence logits
    [B, nb_classes] and the class-query attention maps [B, nb_classes, N]
    that the decoupled decoder reads (`dig_tpu/models/rec_model.py:224-249`)."""

    def __init__(self, dim: int, nb_classes: int = 97, dtype=torch.float32):
        super().__init__()
        self.cls_queries = nn.Parameter(torch.zeros(1, nb_classes, dim))
        self.presence = Dense(dim, 1, dtype=dtype)

    def forward(self, feat_map):
        b, _, c = feat_map.shape
        q = self.cls_queries.to(feat_map.dtype).expand(b, -1, -1)
        logits = torch.einsum("bqc,bnc->bqn", q, feat_map) * c**-0.5
        attn = torch.softmax(logits.float(), dim=-1).to(feat_map.dtype)
        pooled = torch.einsum("bqn,bnc->bqc", attn, feat_map)
        return self.presence(pooled)[..., 0], attn


class SeqClsRecModel(nn.Module):
    """A recognizer with the multi-label branch, whose attention maps feed a
    `DecoupledTFDecoder` (`dig_tpu/models/rec_model.py:252-310`)."""

    def __init__(self, encoder: nn.Module, decoder: TFDecoder, nb_classes: int = 97,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.linear_norm = LinearNorm(encoder.embed_dim, decoder.d_embedding, dtype)
        self.multi_label = MultiLabelHead(encoder.embed_dim, nb_classes, dtype)
        self.decoder = decoder

    def forward(self, images, targets, tgt_lens, deterministic: bool = False, generator=None):
        """-> (logits [B, T, num_classes], presence logits, class-query maps)."""
        generator = training_generator(deterministic, generator)
        enc = self.encoder(images, generator)
        cls_logit, cls_maps = self.multi_label(enc)
        dec_in = self.linear_norm(enc)
        if isinstance(self.decoder, DecoupledTFDecoder):
            logits = self.decoder.decoupled_forward(dec_in, targets, tgt_lens, cls_maps,
                                                    deterministic, generator)
        else:
            logits = self.decoder(dec_in, targets, tgt_lens, deterministic, generator)
        return logits, cls_logit, cls_maps

    @torch.no_grad()
    def recognize(self, images, beam_width: int = 0, eos: int = 94, with_cls: bool = False):
        """Decoding through the decoupled graph (dense greedy, stopping at
        `eos` >= 0, or beam); with `with_cls` the presence logits
        [B, nb_classes] are returned third."""
        enc = self.encoder(images)
        cls_logit, cls_maps = self.multi_label(enc)
        dec_in = self.linear_norm(enc)
        greedy_eos = eos if eos >= 0 else None
        if isinstance(self.decoder, DecoupledTFDecoder):
            if beam_width > 0:
                out = None, self.decoder.decoupled_beam_search(dec_in, cls_maps, beam_width, eos)
            else:
                out = self.decoder.decoupled_greedy_decode(dec_in, cls_maps, greedy_eos)
        elif beam_width > 0:
            out = None, self.decoder.beam_search(dec_in, beam_width, eos)
        else:
            out = self.decoder.greedy_decode_dense(dec_in, greedy_eos)
        return (*out, cls_logit) if with_cls else out


# learned tokens and tables, truncated normal (std 0.02) as the JAX package
# initializes them (`trunc_normal_init`, `MultiLabelHead.cls_queries`)
_TOKEN_PARAMS = ("cls_token", "cls_type_emb", "vis_type_emb", "mem_bank", "pos_embed",
                 "cls_queries")


def _trunc_normal(w, std, generator):
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init in the JAX package's distributions: truncated normal
    (std 0.02) for the encoder's dense layers and the learned tokens,
    xavier-uniform for the patch projection, flax's lecun-normal for the
    other dense layers, the convolutions and the GRU's weights, N(0, 1) for the embeddings,
    zero biases, unit norm scales."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, Dense):
                if name.startswith("encoder."):
                    _trunc_normal(mod.weight, 0.02, generator)
                else:
                    # lecun_normal: truncated normal, variance 1 / fan_in
                    _trunc_normal(mod.weight, math.sqrt(1.0 / mod.in_features)
                                  / 0.87962566103423978, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, PatchEmbed):
                w = mod.proj.weight
                fan_in, fan_out = w[0].numel(), w.shape[0]
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                nn.init.uniform_(w, -bound, bound, generator=generator)
                mod.proj.bias.zero_()
            elif isinstance(mod, Conv3x3):  # flax nn.Conv: lecun_normal, fan_in c_in x 3 x 3
                _trunc_normal(mod.weight, math.sqrt(1.0 / mod.weight[0].numel())
                              / 0.87962566103423978, generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, 0.0, 1.0, generator=generator)
            elif isinstance(mod, GRU):
                for w in (mod.weight_ih_l0, mod.weight_hh_l0):
                    _trunc_normal(w, math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978,
                                  generator)
            for pname, p in mod.named_parameters(recurse=False):
                if pname in _TOKEN_PARAMS:
                    _trunc_normal(p, 0.02, generator)


def build_rec_model(model_name: str = "vit_small_patch4_32x128",
                    decoder_name: str = "tf_decoder", nb_classes: int = 97,
                    max_len: int = 25, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                    drop_path_rate: float = 0.0, use_1d_attdec: bool = False,
                    use_mean_pooling: bool = True, use_feat_distill: bool = False,
                    text_cond_vis: bool = False, use_mim_proj: bool = False,
                    dtype=torch.float32, model_kind: str = "rec", seed: int = 0,
                    device="cuda") -> nn.Module:
    """Build the recognizer of `model_kind` (rec | ctc | attn | seq_cls |
    mim_rec; `dig_tpu/models/rec_model.py:313-399`) with random weights
    from `seed` (made on the CPU, so one seed gives the same weights on
    every device), then move it to `device`.  The encoder's rates are the
    fine-tuning CLI's `--drop`, `--attn_drop_rate` and `--drop_path`; the
    decoder's dropout is 0.1, as the JAX package hard-codes it.

    ``mim_rec`` builds the SimMIM encoder of `model_name` (``simmim_`` is
    prefixed to a plain name) and refuses a ``pretrain_*`` name;
    ``seq_cls`` builds the encoder with class queries (`max_len` of them)
    unless the name already has them.  The decoupled decoder comes with the
    multi-label head (`SeqClsRecModel`).  `use_feat_distill` needs ``rec``
    with another decoder (`dig_tpu` builds the decoupled model without the
    projector and its distillation step then fails).  An unknown kind raises
    (`dig_tpu` builds ``rec`` for it)."""
    if use_feat_distill and (model_kind != "rec" or decoder_name == "decoupled_tf_decoder"):
        raise ValueError(f"use_feat_distill requires model_kind 'rec' with a transformer "
                         f"decoder (got {model_kind!r}, {decoder_name!r}): feat_proj lives on "
                         f"RecModel only")
    rates = dict(drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                 drop_path_rate=drop_path_rate, dtype=dtype)
    if model_kind == "mim_rec":
        if model_name.startswith("pretrain_"):
            raise ValueError(f"--model_kind mim_rec needs a plain or simmim_* encoder name, not "
                             f"the pretrain model {model_name!r} (e.g. vit_small_patch4_32x128)")
        simmim = model_name if model_name.startswith("simmim_") else "simmim_" + model_name
        encoder = create_model(simmim, **rates)
        decoder = create_decoder(decoder_name, nb_classes, max_len, dtype=dtype)
        p = encoder.patch_embed.patch_size
        model = MimRecModel(encoder, decoder, use_mim_proj, pix_classes=p * p * 3, dtype=dtype)
    else:
        enc_kw = dict(rates, use_mean_pooling=use_mean_pooling, return_feat_map=True)
        encoder = create_model(model_name, **enc_kw)
        if model_kind == "ctc":
            model = CTCRecModel(encoder, nb_classes, dtype=dtype)
        elif model_kind == "attn":
            model = AttnRecModel(encoder, nb_classes, max_len, dtype)
        elif model_kind == "seq_cls":
            if not encoder.use_seq_cls_token:
                encoder = create_model(model_name, use_seq_cls_token=True, max_seq_len=max_len,
                                       **enc_kw)
            model = SeqClsTokenRecModel(encoder, nb_classes, dtype)
        elif model_kind == "rec":
            decoder = create_decoder(decoder_name, nb_classes, max_len, dtype=dtype,
                                     text_cond_vis=text_cond_vis)
            if decoder_name == "decoupled_tf_decoder":
                model = SeqClsRecModel(encoder, decoder, nb_classes, dtype)
            else:
                model = RecModel(encoder, decoder, use_1d_attdec, use_feat_distill, dtype)
        else:
            raise ValueError(f"unknown model_kind {model_kind!r} "
                             f"(rec | ctc | attn | seq_cls | mim_rec)")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
