"""Weights across packages, in the reference torch `state_dict` layout.

* `params_from_jax(tree)`: the parameter tree of any of the JAX package's
  recognizers (nested dicts of numpy arrays: ``encoder``, ``linear_norm``,
  ``decoder`` and the heads of the other kinds) -> this package's
  `state_dict()` of the same kind.  Where the reference has a layout
  (encoder, linear_norm, the transformer decoders, the GRU head) it is the
  one `dig_tpu/utils/export_torch.py` writes, that exporter's mapping kept
  here as its own copy; flax's GRU keeps one bias for each of the r and z
  gates (the sum of torch's two), which goes to ``bias_ih`` beside a zero
  ``bias_hh``: the same function.
* `moco_params_from_jax(student, ema)`: the JAX package's pre-training
  parameter trees (the student's and the momentum branch's) -> this
  package's `DiGPretrainModel.state_dict()`, in the reference `MoCo_ViT`
  layout that `dig_tpu/utils/checkpoint.py::convert_torch_moco` reads.
* `load_pth(path)`: a reference-layout `.pth` -> a state dict for
  `RecModel.load_state_dict`.

The sinusoid tables are recomputed at construction and never stored.
"""

from __future__ import annotations

import re

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
    for token in ("mask_token", "pos_embed", "cls_token", "cls_type_emb", "vis_type_emb",
                  "mem_bank"):
        if token in tree:
            out[token] = _t(tree[token])
    for name, blk in tree.items():
        if name.startswith("blocks_"):
            b = f"blocks.{name[len('blocks_'):]}."
            out.update({b + k: v for k, v in block_from_jax(blk).items()})
    for norm in ("norm", "fc_norm"):
        if norm in tree:
            out.update(_norm(tree[norm], norm))
    if "head" in tree:
        out.update(_dense(tree["head"], "head"))
    return out


def decoder_from_jax(tree: dict) -> dict:
    """`TFDecoder` / `DecoupledTFDecoder` tree (text-conditional
    cross-attention included) -> its state dict (keys relative to the
    decoder).  The decoupled extras sit on the decoder in the JAX tree
    (``order2cls_i``, ``new_linear_v_i``) and on each layer here, as in the
    reference (models/transformer_layer.py:157-165)."""
    out = {
        "trg_word_emb.weight": _t(tree["trg_word_emb"]["embedding"]),
        "layer_norm.weight": _t(tree["layer_norm"]["scale"]),
        "layer_norm.bias": _t(tree["layer_norm"]["bias"]),
        "classifier.weight": _t(np.asarray(tree["classifier"]["kernel"]).T),
        "classifier.bias": _t(tree["classifier"]["bias"]),
    }
    if "order_enc" in tree:
        out["order_enc.weight"] = _t(tree["order_enc"]["embedding"])
    for name, blk in tree.items():
        if name.startswith("order2cls_"):
            b = f"layer_stack.{name[len('order2cls_'):]}.mlp_order2cls_attn."
            out.update({**_dense(blk["Dense_0"], b + "0"), **_dense(blk["Dense_1"], b + "3")})
        elif name.startswith("new_linear_v_"):
            out.update(_dense(blk, f"layer_stack.{name[len('new_linear_v_'):]}.new_linear_v"))
        if not name.startswith("layers_"):
            continue
        b = f"layer_stack.{name[len('layers_'):]}."
        for attn in ("self_attn", "enc_attn"):
            for mod, sub in blk[attn].items():
                key = f"{b}{attn}.{mod}"
                out.update(_norm(sub, key) if "scale" in sub else _dense(sub, key))
        for norm in ("norm1", "norm2", "norm3"):
            out.update(_norm(blk[norm], b + norm))
        for w in ("w_1", "w_2"):
            out.update(_dense(blk["mlp"][w], f"{b}mlp.{w}"))
    return out


def attn_head_from_jax(tree: dict) -> dict:
    """`AttentionRecognitionHead` tree -> the reference GRU head's keys
    below `AttnRecModel.decoder` (``decoder.attention_unit.sEmbed``, ...)."""
    out = {}
    for src, dst in (("s_embed", "attention_unit.sEmbed"), ("x_embed", "attention_unit.xEmbed"),
                     ("w_embed", "attention_unit.wEmbed"), ("fc", "fc")):
        out.update(_dense(tree[src], "decoder." + dst))
    out["decoder.tgt_embedding.weight"] = _t(tree["tgt_embedding"]["embedding"])
    gru = tree["gru"]
    h = np.asarray(gru["hr"]["kernel"]).shape[0]
    zeros = np.zeros(h, np.float32)
    out["decoder.gru.weight_ih_l0"] = _t(np.concatenate(
        [np.asarray(gru["i" + g]["kernel"]).T for g in "rzn"]))
    out["decoder.gru.weight_hh_l0"] = _t(np.concatenate(
        [np.asarray(gru["h" + g]["kernel"]).T for g in "rzn"]))
    out["decoder.gru.bias_ih_l0"] = _t(np.concatenate([np.asarray(gru["i" + g]["bias"])
                                                       for g in "rzn"]))
    out["decoder.gru.bias_hh_l0"] = _t(np.concatenate([zeros, zeros, gru["hn"]["bias"]]))
    return out


def _dense(tree: dict, key: str) -> dict:
    out = {key + ".weight": _t(np.asarray(tree["kernel"]).T)}
    if "bias" in tree:
        out[key + ".bias"] = _t(tree["bias"])
    return out


def _norm(tree: dict, key: str) -> dict:
    return {key + ".weight": _t(tree["scale"]), key + ".bias": _t(tree["bias"])}


def _sequential(tree: dict) -> dict:
    """A flax `nn.Sequential` (``layers_i``: Dense or LayerNorm) -> torch's
    `nn.Sequential` keys (``i``)."""
    out = {}
    for name, sub in tree.items():
        i = name[len("layers_"):]
        out.update(_norm(sub, i) if "scale" in sub else _dense(sub, i))
    return out


def params_from_jax(tree: dict, patch_size: int = 4) -> dict:
    """The JAX params of any recognizer kind -> this package's state dict
    of that kind (`RecModel`, `CTCRecModel`, `AttnRecModel`, `MimRecModel`,
    `SeqClsTokenRecModel`, `SeqClsRecModel`)."""
    sd = {}
    for top, sub in tree.items():
        if "kernel" in sub or "scale" in sub:  # a Dense or a LayerNorm: fc0, norm, fc1, head, ...
            sd.update(_norm(sub, top) if "scale" in sub else _dense(sub, top))
            continue
        if top == "encoder":
            conv = _encoder(sub, patch_size)
        elif top == "linear_norm":
            conv = {**_dense(sub["dense"], "0"), **_norm(sub["norm"], "1")}
        elif top == "decoder":
            conv = attn_head_from_jax(sub) if "gru" in sub else decoder_from_jax(sub)
        elif top in ("pix_head", "mim_proj"):
            conv = _sequential(sub)
        elif top == "feat_proj":
            conv = _mlp_head(sub)
        elif top == "multi_label":
            conv = {"cls_queries": _t(sub["cls_queries"]), **_dense(sub["presence"], "presence")}
        else:
            raise KeyError(f"no port counterpart for the JAX subtree {top!r}")
        sd.update({f"{top}.{k}": v for k, v in conv.items()})
    return sd


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


def _conv_patchnet(tree: dict) -> dict:
    """`ConvPatchNet` (``c{i}_conv``, ``c{i}_bn``, ``p2g_dense0``,
    ``p2g_bn0``, ``p2g_dense1``) -> the reference layout: conv block i at
    ``conv_layers.{2i}`` (kernel [3, 3, in, out] -> [out, in, 3, 3]), the
    head at ``patches2global.{0,1,3}`` (`_convert_conv_patchnet`'s inverse)."""
    out = {}
    for i in range(4):
        conv = tree[f"c{i}_conv"]
        out[f"conv_layers.{2 * i}.0.weight"] = _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        out[f"conv_layers.{2 * i}.0.bias"] = _t(conv["bias"])
        out.update(_norm(tree[f"c{i}_bn"], f"conv_layers.{2 * i}.1"))
    out.update(_dense(tree["p2g_dense0"], "patches2global.0"))
    out.update(_norm(tree["p2g_bn0"], "patches2global.1"))
    out.update(_dense(tree["p2g_dense1"], "patches2global.3"))
    return out


def _patchnet(tree: dict) -> dict:
    return _conv_patchnet(tree) if "c0_conv" in tree else _cross_patchnet(tree)


def _pix_decoder(tree: dict) -> dict:
    out = {**_dense(tree["fc0"], "0"), **_dense(tree["fc1"], "1"), **_dense(tree["head"], "4")}
    out.update(_norm(tree["norm"], "2"))
    return out


def moco_params_from_jax(student: dict, ema: dict, patch_size: int = 4) -> dict:
    """JAX `DiGPretrainModel` params and its EMA tree -> this package's
    `DiGPretrainModel` state dict.  Top-level keys of the JAX trees:
    encoder, patch_extractor, pix_decoder, pix_projector, predictor,
    projection (the EMA tree: encoder, patch_extractor, pix_projector,
    projection); the patch extractor is a `PatchNet` or a `ConvPatchNet`."""
    convert = {"encoder": lambda t: _encoder(t, patch_size), "projection": _mlp_head,
               "predictor": _mlp_head, "pix_projector": _mlp_head,
               "patch_extractor": _patchnet, "pix_decoder": _pix_decoder}
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
    to tensors and the argparse namespace the reference stores beside them
    (`checkpoint.load_torch_checkpoint`, which also reads a remote URI)."""
    from dig_tpu_torch.utils.checkpoint import load_torch_checkpoint

    return {k[len(model_prefix):]: v.float()
            for k, v in load_torch_checkpoint(path, model_key).items()
            if k.startswith(model_prefix)}


# ---------------------------------------------------------------------------
# the same mapping read backwards, for the sharding rules
# ---------------------------------------------------------------------------

# the pre-training model's top-level modules -> the JAX tree's subtree
# (`moco_params_from_jax`'s two tables: the momentum copies sit at the same
# paths of the EMA tree)
_MOCO_TOPS = {"encoder": "encoder", "momentum_encoder": "encoder",
              "encoder_projection_layer": "projection", "momentum_projection_layer": "projection",
              "predictor": "predictor", "pix_projector": "pix_projector",
              "pix_projector_m": "pix_projector", "patch_extractor": "patch_extractor",
              "momentum_patch_extractor": "patch_extractor", "pix_decoder": "pix_decoder"}
_TOKENS = ("mask_token", "pos_embed", "cls_token", "cls_type_emb", "vis_type_emb", "mem_bank")
_GRU_DENSE = {"attention_unit.sEmbed": "s_embed", "attention_unit.xEmbed": "x_embed",
              "attention_unit.wEmbed": "w_embed", "fc": "fc"}
_PIX_DECODER = {"0": "fc0", "1": "fc1", "4": "head"}


def _subtree_path(kind: str, rest: str):
    """(path below the subtree, layout) of a >= 2-D leaf `rest` of a
    subtree converted by `kind`'s function above; layout is "dense" (torch
    [out, in] of flax's [in, out] kernel), "same", "patch", "conv" or "gru";
    None where the key has no counterpart."""
    if kind == "encoder":
        if rest == "patch_embed.proj.weight":
            return ("patch_embed", "proj", "kernel"), "patch"
        if rest in _TOKENS:
            return (rest,), "same"
        if rest == "head.weight":
            return ("head", "kernel"), "dense"
        m = re.fullmatch(r"blocks\.(\d+)\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.weight", rest)
        if m:
            sub = {"attn.qkv": ("attn", "qkv_kernel"), "attn.proj": ("attn", "proj", "kernel"),
                   "mlp.fc1": ("mlp", "Dense_0", "kernel"),
                   "mlp.fc2": ("mlp", "Dense_1", "kernel")}[m.group(2)]
            return (f"blocks_{m.group(1)}",) + sub, "dense"
        return None
    if kind == "mlp_head":
        m = re.fullmatch(r"(\d+)\.weight", rest)
        return ((f"dense_{int(m.group(1)) // 3}", "kernel"), "dense") if m else None
    if kind == "patch_extractor":
        m = re.fullmatch(r"blocks\.(\d+)\.(attn\.linear_[qkv]|attn\.proj|mlp\.fc[12])\.weight",
                         rest)
        if m:
            mod = m.group(2)
            sub = ((f"{mod[-1]}_kernel",) if mod.startswith("attn.linear_") else
                   ("proj", "kernel") if mod == "attn.proj" else
                   ("mlp", f"Dense_{int(mod[-1]) - 1}", "kernel"))
            return (f"blocks_{m.group(1)}",) + sub, "dense"
        m = re.fullmatch(r"conv_layers\.(\d+)\.0\.weight", rest)
        if m:
            return (f"c{int(m.group(1)) // 2}_conv", "kernel"), "conv"
        m = re.fullmatch(r"patches2global\.([03])\.weight", rest)
        return ((f"p2g_dense{int(m.group(1)) // 3}", "kernel"), "dense") if m else None
    if kind == "pix_decoder":
        m = re.fullmatch(r"(\d)\.weight", rest)
        return ((_PIX_DECODER[m.group(1)], "kernel"), "dense") if m else None
    if kind == "linear_norm":
        return (("dense", "kernel"), "dense") if rest == "0.weight" else None
    if kind == "sequential":
        m = re.fullmatch(r"(\d+)\.weight", rest)
        return ((f"layers_{m.group(1)}", "kernel"), "dense") if m else None
    if kind == "multi_label":
        if rest == "cls_queries":
            return ("cls_queries",), "same"
        return (("presence", "kernel"), "dense") if rest == "presence.weight" else None
    if kind == "decoder":
        if rest.startswith("decoder."):  # the GRU head (`attn_head_from_jax`)
            rest = rest[len("decoder."):]
            if rest == "tgt_embedding.weight":
                return ("tgt_embedding", "embedding"), "same"
            if rest in ("gru.weight_ih_l0", "gru.weight_hh_l0"):
                return ("gru", "ir" if "_ih_" in rest else "hr", "kernel"), "gru"
            name = rest[:-len(".weight")]
            return ((_GRU_DENSE[name], "kernel"), "dense") if name in _GRU_DENSE else None
        if rest in ("trg_word_emb.weight", "order_enc.weight"):
            return (rest.split(".")[0], "embedding"), "same"
        if rest == "classifier.weight":
            return ("classifier", "kernel"), "dense"
        m = re.fullmatch(r"layer_stack\.(\d+)\.(.+)\.weight", rest)
        if not m:
            return None
        i, mod = m.groups()
        m2 = re.fullmatch(r"mlp_order2cls_attn\.([03])", mod)
        if m2:
            return (f"order2cls_{i}", f"Dense_{int(m2.group(1)) // 3}", "kernel"), "dense"
        if mod == "new_linear_v":
            return (f"new_linear_v_{i}", "kernel"), "dense"
        return (f"layers_{i}",) + tuple(mod.split(".")) + ("kernel",), "dense"
    return None


def _subtree_kind(top: str) -> str:
    if top in ("projection", "predictor", "pix_projector", "feat_proj"):
        return "mlp_head"
    if top in ("pix_head", "mim_proj"):
        return "sequential"
    return top


def jax_leaf(key: str, shape):
    """Where a >= 2-D port parameter comes from in the JAX package's tree,
    read backwards off the converters above: (JAX path, JAX shape, the port
    axis of each JAX axis, parts).  The path starts at the parameter tree's
    top (the momentum branch's keys at their place in the EMA tree, whose
    paths are the student's).  An axis that the port splits into several
    (the patch projection's flattened p * p * C) maps to None.  `parts` is 3
    for the GRU's gate matrices, the concatenation of three JAX leaves
    along port axis 0 (the path is the first gate's), else 1.  Raises
    KeyError for a key with no counterpart."""
    shape = tuple(int(s) for s in shape)
    top, _, rest = key.partition(".")
    jtop = _MOCO_TOPS.get(top, top)
    if rest == "weight" and len(shape) == 2:  # a Dense at the top: fc0, head
        found = ("kernel",), "dense"
    else:
        found = _subtree_path(_subtree_kind(jtop), rest)
    if found is None:
        raise KeyError(f"no JAX counterpart for the port parameter {key!r} {list(shape)}")
    path, layout = found
    path = (jtop,) + path
    if layout == "dense":
        return path, (shape[1], shape[0]), (1, 0), 1
    if layout == "same":
        return path, shape, tuple(range(len(shape))), 1
    if layout == "patch":  # [D, C, p, p] <- [p * p * C, D]
        return path, (shape[1] * shape[2] * shape[3], shape[0]), (None, 0), 1
    if layout == "conv":  # [out, in, 3, 3] <- [3, 3, in, out]
        return path, (shape[2], shape[3], shape[1], shape[0]), (2, 3, 1, 0), 1
    # gru: [3 h, in] <- three [in, h]
    return path, (shape[1], shape[0] // 3), (1, 0), 3
