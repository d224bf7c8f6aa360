"""Weights to the reference's torch ``state_dict`` layout: the port's
counterpart of `dig_tpu/utils/export_torch.py`, for weights trained here
(or in `dig_tpu`) that must load into the reference ecosystem
(`RecModel.load_state_dict`, models/model_builder.py:74-202;
run_class_finetuning.py --finetune, :362-441).

The port's models already hold the reference's layout: `utils/convert.py`
maps `dig_tpu`'s trees into it with that exporter's mapping.  So exporting
a port state dict chooses keys and copies no tensor, and a native `dig_tpu`
tree goes through `utils/native_ckpt.py` / `utils/convert.py` first.  The
result has exactly the keys and values `dig_tpu`'s exporter writes for the
same weights, under its rules (`dig_tpu/utils/export_torch.py:1-33`):

* buffers the reference recomputes are not written: the port's sinusoid
  tables are non-persistent buffers, in no state dict;
* the encoder's tensors are those `export_torch_encoder` writes
  (`utils/checkpoint.py::ENCODER_KEY`): the class queries, type embeddings,
  memory bank and head of other encoders have no reference layout there;
* the GRU head's r and z biases: flax keeps one bias for each, the sum of
  torch's two; the exporter writes it to ``bias_ih`` beside zeros in
  ``bias_hh`` (the same function), and so does `export_torch_attn_head`
  with the port's two biases summed;
* the `SeqClsRecModel.multi_label` head is not exported; any other head
  without a reference layout (CTC's, seq-cls's, MIM's, the distillation
  projector, a pre-training model's) raises.
"""

from __future__ import annotations

import torch

from dig_tpu_torch.utils import native_ckpt
from dig_tpu_torch.utils.checkpoint import ENCODER_KEY

__all__ = [
    "export_torch_encoder",
    "export_torch_decoder",
    "export_torch_attn_head",
    "export_torch_recognizer",
    "export_checkpoint",
]

# top-level modules of a recognizer with a reference layout; multi_label is dropped
_RECOGNIZER_TOPS = {"encoder", "linear_norm", "decoder", "multi_label"}
# the pre-training model's momentum modules, by the student module each tracks
_MOMENTUM = {"momentum_encoder": "encoder",
             "momentum_projection_layer": "encoder_projection_layer",
             "momentum_patch_extractor": "patch_extractor", "pix_projector_m": "pix_projector"}


class NoEmaError(ValueError):
    """`--ema` on a checkpoint without a momentum branch."""


def _below(state_dict: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def export_torch_encoder(state_dict: dict) -> dict:
    """An encoder's tensors, keyed below it (``blocks.0.attn.qkv.weight``,
    ...) -> those the reference layout has, under ``encoder.``."""
    return {"encoder." + k: v for k, v in state_dict.items() if ENCODER_KEY.fullmatch(k)}


def export_torch_decoder(state_dict: dict) -> dict:
    """A `TFDecoder`'s or `DecoupledTFDecoder`'s tensors (keys below it,
    the text-conditional cross-attention included) -> under ``decoder.``.
    The port's decoders hold the reference's parameters and nothing else,
    so every tensor passes as it is."""
    return {"decoder." + k: v for k, v in state_dict.items()}


def export_torch_attn_head(state_dict: dict) -> dict:
    """The GRU head's tensors, keyed below `AttnRecModel.decoder`
    (``decoder.attention_unit.sEmbed.weight``, ``decoder.gru.*``, ...) ->
    under ``decoder.``, the r and z parts of ``bias_hh_l0`` moved into
    ``bias_ih_l0`` (zeros left behind), as `dig_tpu` writes flax's merged
    biases."""
    out = {"decoder." + k: v for k, v in state_dict.items()}
    b_ih, b_hh = state_dict["decoder.gru.bias_ih_l0"], state_dict["decoder.gru.bias_hh_l0"]
    rz = 2 * state_dict["decoder.gru.weight_hh_l0"].shape[1]  # the r and z gates' rows
    out["decoder.decoder.gru.bias_ih_l0"] = torch.cat([b_ih[:rz] + b_hh[:rz], b_ih[rz:]])
    out["decoder.decoder.gru.bias_hh_l0"] = torch.cat([torch.zeros_like(b_hh[:rz]), b_hh[rz:]])
    return out


def _refuse_heads(tops) -> None:
    extra = sorted(set(tops) - _RECOGNIZER_TOPS)
    if extra:
        raise ValueError(
            f"param trees {extra} have no reference .pth layout — this head family cannot be "
            "exported as a reference recognizer (export the ViT alone with --encoder_only)")


def export_torch_recognizer(state_dict: dict) -> dict:
    """A recognizer's state dict -> the reference's fine-tuned checkpoint
    layout: the encoder, ``linear_norm`` and the decoder (transformer or
    GRU head).  A module without a reference layout raises; `multi_label`
    is dropped."""
    _refuse_heads({k.split(".")[0] for k in state_dict})
    out = export_torch_encoder(_below(state_dict, "encoder."))
    out.update({k: v for k, v in state_dict.items() if k.startswith("linear_norm.")})
    decoder = _below(state_dict, "decoder.")
    if any(k.startswith("decoder.gru.") for k in decoder):
        out.update(export_torch_attn_head(decoder))
    elif decoder:
        out.update(export_torch_decoder(decoder))
    return out


def _momentum_branch(state_dict: dict) -> dict:
    """A pre-training state dict's momentum modules under their students' names."""
    out = {}
    for momentum, student in _MOMENTUM.items():
        out.update({f"{student}.{k}": v for k, v in _below(state_dict, momentum + ".").items()})
    return out


def export_checkpoint(payload: dict, encoder_only: bool = False, ema: bool = False,
                      patch_size: int = 4) -> dict:
    """What `tools/export_pth.py` writes for a restored checkpoint
    (`utils/checkpoint.py::restore_checkpoint`): a port payload (its
    "model" state dict) or a native `dig_tpu` one (its "native" trees).
    `ema` takes the momentum branch (a native tree's ``ema_params``),
    `encoder_only` the encoder alone (of a recognizer or a pre-training
    model); otherwise the whole recognizer.  `NoEmaError` when
    `ema` finds no momentum branch."""
    if "native" in payload:
        trees = payload["native"]
        if ema:
            if trees.get("ema_params") is None:
                raise NoEmaError("carries no EMA tree")
            trees = {"params": trees["ema_params"]}
        if encoder_only:
            return export_torch_encoder(native_ckpt.encoder_state_dict(trees, patch_size))
        _refuse_heads(trees["params"])  # before the converter meets a pretrain tree
        return export_torch_recognizer(native_ckpt.model_state_dict(trees, False, patch_size))
    state_dict = payload["model"]
    if ema:
        state_dict = _momentum_branch(state_dict)
        if not state_dict:
            raise NoEmaError("carries no momentum branch")
    if encoder_only:
        return export_torch_encoder(_below(state_dict, "encoder."))
    return export_torch_recognizer(state_dict)
