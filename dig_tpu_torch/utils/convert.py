"""Weights across packages, in the reference torch `state_dict` layout.

* `params_from_jax(tree)`: the JAX package's `RecModel` parameter tree
  (nested dicts of numpy arrays: ``encoder`` / ``linear_norm`` /
  ``decoder``) -> this package's `RecModel.state_dict()`.  The key layout
  is the one `dig_tpu/utils/export_torch.py:211-243` writes, so this is
  that exporter's mapping, kept here as its own copy.
* `moco_params_from_jax(student, ema)`: the JAX package's pre-training
  parameter trees (the student's and the momentum branch's) -> this
  package's `DiGPretrainModel.state_dict()`, in the reference `MoCo_ViT`
  layout that `dig_tpu/utils/checkpoint.py::convert_torch_moco` reads.
* `load_pth(path)`: a reference-layout `.pth` -> a state dict for
  `RecModel.load_state_dict`.

The sinusoid tables are recomputed at construction and never stored.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def block_from_jax(blk: dict) -> dict:
    """One ViT `Block` tree -> its state dict (keys relative to the block)."""
    out = {}
    attn = blk["attn"]
    out["attn.qkv.weight"] = _t(np.asarray(attn["qkv_kernel"]).T)
    if "q_bias" in attn:
        out["attn.q_bias"] = _t(attn["q_bias"])
        out["attn.v_bias"] = _t(attn["v_bias"])
    out["attn.proj.weight"] = _t(np.asarray(attn["proj"]["kernel"]).T)
    out["attn.proj.bias"] = _t(attn["proj"]["bias"])
    for norm in ("norm1", "norm2"):
        out[norm + ".weight"] = _t(blk[norm]["scale"])
        out[norm + ".bias"] = _t(blk[norm]["bias"])
    for src, dst in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
        out[f"mlp.{dst}.weight"] = _t(np.asarray(blk["mlp"][src]["kernel"]).T)
        out[f"mlp.{dst}.bias"] = _t(blk["mlp"][src]["bias"])
    for g in ("gamma_1", "gamma_2"):
        if g in blk:
            out[g] = _t(blk[g])
    return out


def _encoder(tree: dict, patch_size: int) -> dict:
    out = {}
    pe = tree["patch_embed"]["proj"]
    kernel = np.asarray(pe["kernel"])  # [p*p*C, D], rows flattened as (p, p, c)
    p = patch_size
    out["patch_embed.proj.weight"] = _t(
        kernel.reshape(p, p, kernel.shape[0] // (p * p), -1).transpose(3, 2, 0, 1))
    out["patch_embed.proj.bias"] = _t(pe["bias"])
    if "mask_token" in tree:
        out["mask_token"] = _t(tree["mask_token"])
    for name, blk in tree.items():
        if name.startswith("blocks_"):
            b = f"blocks.{name[len('blocks_'):]}."
            out.update({b + k: v for k, v in block_from_jax(blk).items()})
    if "norm" in tree:
        out["norm.weight"] = _t(tree["norm"]["scale"])
        out["norm.bias"] = _t(tree["norm"]["bias"])
    return out


def decoder_from_jax(tree: dict) -> dict:
    """`TFDecoder` tree -> its state dict (keys relative to the decoder)."""
    out = {
        "trg_word_emb.weight": _t(tree["trg_word_emb"]["embedding"]),
        "layer_norm.weight": _t(tree["layer_norm"]["scale"]),
        "layer_norm.bias": _t(tree["layer_norm"]["bias"]),
        "classifier.weight": _t(np.asarray(tree["classifier"]["kernel"]).T),
        "classifier.bias": _t(tree["classifier"]["bias"]),
    }
    for name, blk in tree.items():
        if not name.startswith("layers_"):
            continue
        b = f"layer_stack.{name[len('layers_'):]}."
        for attn in ("self_attn", "enc_attn"):
            for mod in ("linear_q", "linear_k", "linear_v", "fc"):
                out[b + f"{attn}.{mod}.weight"] = _t(np.asarray(blk[attn][mod]["kernel"]).T)
        for norm in ("norm1", "norm2", "norm3"):
            out[b + norm + ".weight"] = _t(blk[norm]["scale"])
            out[b + norm + ".bias"] = _t(blk[norm]["bias"])
        for w in ("w_1", "w_2"):
            out[b + f"mlp.{w}.weight"] = _t(np.asarray(blk["mlp"][w]["kernel"]).T)
            out[b + f"mlp.{w}.bias"] = _t(blk["mlp"][w]["bias"])
    return out


def params_from_jax(tree: dict, patch_size: int = 4) -> dict:
    """JAX `RecModel` params -> this package's `RecModel` state dict."""
    sd = {"encoder." + k: v for k, v in _encoder(tree["encoder"], patch_size).items()}
    ln = tree["linear_norm"]
    sd["linear_norm.0.weight"] = _t(np.asarray(ln["dense"]["kernel"]).T)
    sd["linear_norm.0.bias"] = _t(ln["dense"]["bias"])
    sd["linear_norm.1.weight"] = _t(ln["norm"]["scale"])
    sd["linear_norm.1.bias"] = _t(ln["norm"]["bias"])
    sd.update({"decoder." + k: v for k, v in decoder_from_jax(tree["decoder"]).items()})
    return sd


def _dense(tree: dict, key: str) -> dict:
    out = {key + ".weight": _t(np.asarray(tree["kernel"]).T)}
    if "bias" in tree:
        out[key + ".bias"] = _t(tree["bias"])
    return out


def _norm(tree: dict, key: str) -> dict:
    return {key + ".weight": _t(tree["scale"]), key + ".bias": _t(tree["bias"])}


def _mlp_head(tree: dict) -> dict:
    """`MLPHead` (dense_l, bn_l) -> the reference Sequential: Linear at
    index 3l, its BatchNorm at 3l + 1 (affine BNs only)."""
    out = {}
    for name, sub in tree.items():
        kind, layer = name.rsplit("_", 1)
        idx = 3 * int(layer) + (kind == "bn")
        out.update(_dense(sub, str(idx)) if kind == "dense" else _norm(sub, str(idx)))
    return out


def _cross_patchnet(tree: dict) -> dict:
    """`PatchNet` with its bias-free `CrossBlock`s -> the reference layout."""
    out = {}
    for name, blk in tree.items():
        if name == "norm":
            out.update(_norm(blk, "norm"))
            continue
        b = f"blocks.{name[len('blocks_'):]}."
        for w in ("q", "k", "v"):
            out[b + f"attn.linear_{w}.weight"] = _t(np.asarray(blk[f"{w}_kernel"]).T)
        out.update(_dense(blk["proj"], b + "attn.proj"))
        out.update(_norm(blk["norm1"], b + "norm1"))
        out.update(_norm(blk["norm2"], b + "norm2"))
        out.update(_dense(blk["mlp"]["Dense_0"], b + "mlp.fc1"))
        out.update(_dense(blk["mlp"]["Dense_1"], b + "mlp.fc2"))
    return out


def _pix_decoder(tree: dict) -> dict:
    out = {**_dense(tree["fc0"], "0"), **_dense(tree["fc1"], "1"), **_dense(tree["head"], "4")}
    out.update(_norm(tree["norm"], "2"))
    return out


def moco_params_from_jax(student: dict, ema: dict, patch_size: int = 4) -> dict:
    """JAX `DiGPretrainModel` params and its EMA tree -> this package's
    `DiGPretrainModel` state dict.  Top-level keys of the JAX trees:
    encoder, patch_extractor, pix_decoder, pix_projector, predictor,
    projection (the EMA tree: encoder, patch_extractor, pix_projector,
    projection)."""
    convert = {"encoder": lambda t: _encoder(t, patch_size), "projection": _mlp_head,
               "predictor": _mlp_head, "pix_projector": _mlp_head,
               "patch_extractor": _cross_patchnet, "pix_decoder": _pix_decoder}
    names = {"encoder": "encoder", "projection": "encoder_projection_layer",
             "predictor": "predictor", "pix_projector": "pix_projector",
             "patch_extractor": "patch_extractor", "pix_decoder": "pix_decoder"}
    ema_names = {"encoder": "momentum_encoder", "projection": "momentum_projection_layer",
                 "pix_projector": "pix_projector_m",
                 "patch_extractor": "momentum_patch_extractor"}
    sd = {}
    for tree, table in ((student, names), (ema, ema_names)):
        for key, sub in tree.items():
            sd.update({f"{table[key]}.{k}": v for k, v in convert[key](sub).items()})
    return sd


def load_pth(path: str, model_key: str = "model|module", model_prefix: str = "") -> dict:
    """Read a reference-layout recognizer `.pth`.  `model_key` is the
    reference's '|'-separated list of candidate top-level keys
    (run_class_finetuning.py:372-377), with ``state_dict`` tried last;
    `model_prefix` is stripped from every key.  Unpickling is restricted
    to tensors and the argparse namespace the reference stores beside them."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in model_key.split("|") + ["state_dict"]:
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k[len(model_prefix):]: v.float() for k, v in ckpt.items()
            if k.startswith(model_prefix) and torch.is_tensor(v)}
