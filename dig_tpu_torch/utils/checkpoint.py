"""Checkpoints of the port: save, restore, auto-resume, pruning.

The semantics are those of `dig_tpu/utils/checkpoint.py` (reference:
utils/utils.py:546-669); the payload is the port's own.

* A checkpoint is a directory ``{output_dir}/checkpoint-{tag}`` holding
  ``checkpoint.pth`` and ``meta.json``.
* ``checkpoint.pth`` is one `torch.save` of ``{"model": state_dict,
  "optimizer": {"inner": torch.optim.AdamW state_dict, "count": int},
  "step": int}``, written to a temporary name and renamed.  Under
  gradient accumulation the optimizer entry also holds the running mean
  and its count (``"acc"``, ``"mini_step"``), as optax's `MultiSteps`
  state does.  The state dict
  is the model's own, in the reference's `MoCo_ViT` key layout with the
  momentum modules included, so `dig_tpu_torch.utils.convert.load_pth` and
  the JAX package's `--finetune x.pth` loading (`convert_torch_moco`) read
  the file as it is.  It is loaded with ``weights_only=True``.
* ``meta.json`` (``{"step", "extra"}``) is written last and atomically: it
  is the commit marker.  A directory without it (a save that was killed
  half-way) is invisible to `numeric_checkpoints`, `latest_checkpoint` and
  `auto_resume`, so it never shadows an older complete checkpoint.
* `auto_resume` takes the newest numeric checkpoint that restores, falling
  back past a corrupt one; `prune_checkpoints` deletes the oldest numeric
  ones beyond `keep` and never touches other tags (``checkpoint-best``,
  mid-epoch ``checkpoint-3_100``).

Restoring puts back everything a step reads: the parameters, the momentum
modules, AdamW's moments and step tensors, the optimizer's schedule index
`count` and `state.step`.  Restore *after* `init_pretrain_state`, which
resets the momentum branch to the student.

Weights from elsewhere (`dig_tpu/utils/checkpoint.py:375-414, 766-906`),
as state-dict operations on the reference key layout that the port's
models use: `load_torch_checkpoint` (the ``--model_key`` order),
`convert_torch_encoder` (the prefix order), `convert_torch_recognizer`,
`has_decoder_keys`, and `merge_pretrained_tree`, which grafts what fits
onto a model.

Not ported yet (see ROADMAP.md): remote URIs (``gs://...`` through fsspec),
reading the JAX package's native directories (``arrays.npz`` +
``treedef.pkl``), both refused with a message, and `interpolate_pos_embed`,
which waits for the learnable position table: the ported encoders hold a
fixed sinusoid table, so a checkpoint's ``pos_embed`` is reported unused.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from typing import Optional

import torch

PAYLOAD = "checkpoint.pth"


def _refuse_remote(path: str) -> None:
    if "://" in path:
        raise NotImplementedError(
            f"remote checkpoint URIs ({path!r}) are not ported yet; see ROADMAP.md")


def _replace_into(path: str, name: str, write) -> None:
    """write(tmp path), then rename onto `name` inside `path`."""
    tmp = os.path.join(path, "tmp_" + name)
    write(tmp)
    os.replace(tmp, os.path.join(path, name))


def save_checkpoint(output_dir: str, tag, state, extra: Optional[dict] = None) -> str:
    """Write ``{output_dir}/checkpoint-{tag}`` from a `TrainState`; returns its path."""
    _refuse_remote(output_dir)
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{tag}"))
    os.makedirs(path, exist_ok=True)
    opt = state.optimizer
    payload = {"model": state.model.state_dict(),
               "optimizer": {"inner": opt.inner.state_dict(), "count": int(opt.count)},
               "step": int(state.step)}
    if opt.acc is not None:
        payload["optimizer"].update(acc=opt.acc, mini_step=int(opt.mini_step))
    _replace_into(path, PAYLOAD, lambda tmp: torch.save(payload, tmp))
    meta = {"step": int(state.step)}
    if extra:
        meta["extra"] = extra

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _replace_into(path, "meta.json", write_meta)
    return path


def refuse_unreadable(path: str) -> None:
    """Raise for a checkpoint path the port cannot read: a remote URI, or a
    directory in the JAX package's native format."""
    _refuse_remote(path)
    if os.path.exists(os.path.join(path, "arrays.npz")):
        raise NotImplementedError(
            f"{path} is a native dig_tpu checkpoint (arrays.npz + treedef.pkl), which the "
            f"port does not read yet; export it with tools/export_pth.py (see ROADMAP.md)")


def restore_checkpoint(path: str) -> dict:
    """Load a checkpoint directory onto the CPU: the payload's keys plus
    "step" and, where the save gave one, "extra" from ``meta.json``."""
    refuse_unreadable(path)
    path = os.path.abspath(path)
    payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    payload["step"] = meta["step"]
    if "extra" in meta:
        payload["extra"] = meta["extra"]
    return payload


def load_into_state(state, payload: dict):
    """Put a restored payload into `state`, in place: model (student and
    momentum modules), AdamW moments and step tensors, the schedule index
    and the step counter.  Returns `state`.

    Only the optimizer's per-parameter state is taken from the file.  Its
    hyper-parameters (betas, eps, the groups' lr scales) stay those the
    optimizer was built with, as in the JAX package, whose optimizer state
    holds none: the flags of the resuming run decide."""
    state.model.load_state_dict(payload["model"])
    inner = state.optimizer.inner
    saved, groups = payload["optimizer"]["inner"], inner.state_dict()["param_groups"]
    if [len(g["params"]) for g in saved["param_groups"]] != [len(g["params"]) for g in groups]:
        raise ValueError("the checkpoint's optimizer groups its parameters differently from "
                         "this run's (another model, layer decay or frozen layers)")
    inner.load_state_dict({"state": saved["state"], "param_groups": groups})
    state.optimizer.count = int(payload["optimizer"]["count"])
    if "acc" in payload["optimizer"]:
        device = state.optimizer.params[0].device
        state.optimizer.acc = [a.to(device) for a in payload["optimizer"]["acc"]]
        state.optimizer.mini_step = int(payload["optimizer"]["mini_step"])
    state.step = int(payload["step"])
    return state


def _numbered(output_dir: str) -> list:
    """[(N, name)] of the ``checkpoint-N`` entries under `output_dir`, ascending."""
    if not os.path.isdir(output_dir):
        return []
    return sorted((int(m.group(1)), n) for n in os.listdir(output_dir)
                  if (m := re.fullmatch(r"checkpoint-(\d+)", n)))


def numeric_checkpoints(output_dir: str) -> list:
    """Complete (meta.json-bearing) ``checkpoint-N`` paths, newest first."""
    _refuse_remote(output_dir)
    return [os.path.join(output_dir, n) for _, n in reversed(_numbered(output_dir))
            if os.path.exists(os.path.join(output_dir, n, "meta.json"))]


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The highest-numbered complete ``checkpoint-N`` directory, or None."""
    paths = numeric_checkpoints(output_dir)
    return paths[0] if paths else None


def prune_checkpoints(output_dir: str, keep: int) -> list:
    """Delete the oldest numeric ``checkpoint-N`` directories beyond the
    newest `keep` (0 or negative keeps all, the reference's behaviour);
    returns the names deleted.  Other tags are never touched."""
    _refuse_remote(output_dir)
    if keep <= 0:
        return []
    numbered = _numbered(output_dir)
    pruned = []
    for _, name in numbered[:-keep] if keep < len(numbered) else []:
        shutil.rmtree(os.path.join(output_dir, name), ignore_errors=True)
        pruned.append(name)
    return pruned


def auto_resume(output_dir: str, state):
    """Restore the newest restorable checkpoint into `state`; returns
    (state, extra), extra None when nothing was restored.  Falls back to
    older checkpoints when the newest is corrupt instead of silently
    starting fresh."""
    for path in numeric_checkpoints(output_dir):
        try:
            payload = restore_checkpoint(path)
        except Exception as e:  # a partial or corrupt checkpoint: try the one before, as the reference does
            print(f"auto-resume failed for {path}: {e}")
            continue
        load_into_state(state, payload)
        print(f"auto-resumed from {path}")
        return state, payload.get("extra")
    return state, None


# ---------------------------------------------------------------------------
# Weights from reference checkpoints and from the port's pre-training
# ---------------------------------------------------------------------------

# the encoder tensors `dig_tpu/utils/checkpoint.py::convert_torch_encoder` maps
_ENCODER_KEY = re.compile(
    r"patch_embed\.proj\.(weight|bias)|mask_token|pos_embed|(fc_)?norm\.(weight|bias)"
    r"|blocks\.\d+\.(attn\.(qkv\.weight|q_bias|v_bias|proj\.(weight|bias))"
    r"|norm[12]\.(weight|bias)|mlp\.fc[12]\.(weight|bias)|gamma_[12])")


def load_torch_checkpoint(path: str, model_key: str = "model|module") -> dict:
    """A `.pth` -> its state dict of tensors.  `model_key` is the
    reference's ``--model_key``, a '|'-separated list of candidate
    top-level keys tried in order (run_class_finetuning.py:372-377), with
    ``state_dict`` tried last; a file with none of them is the state dict
    itself.  Unpickling is restricted to tensors, containers and the
    argparse namespace the reference stores beside them."""
    _refuse_remote(path)
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in model_key.split("|") + ["state_dict"]:
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v for k, v in ckpt.items() if torch.is_tensor(v)}


def convert_torch_encoder(state_dict: dict, prefix: str = "encoder.") -> dict:
    """The encoder's tensors of a state dict, keyed as in `VisionTransformer`
    (``blocks.0.attn.qkv.weight``, ...).  The prefix is searched as the JAX
    package searches it (run_class_finetuning.py:388-396): `prefix` first,
    then ``backbone.``, then ``encoder.``, then the bare keys; of the keys
    under it, those the JAX converter maps (patch embedding, mask token,
    position table, blocks, final norms)."""
    sd = state_dict
    for pfx in (prefix, "backbone.", "encoder."):
        stripped = {k[len(pfx):]: v for k, v in state_dict.items() if k.startswith(pfx)}
        if stripped:
            sd = stripped
            break
    return {k: v for k, v in sd.items() if _ENCODER_KEY.fullmatch(k)}


def convert_torch_recognizer(state_dict: dict) -> dict:
    """A fine-tuned reference recognizer's state dict -> {"encoder": ...,
    "linear_norm": ..., "decoder": ...}, each keyed below its module."""
    tree = {"encoder": convert_torch_encoder(state_dict, prefix="encoder.")}
    for top in ("linear_norm", "decoder"):
        tree[top] = {k[len(top) + 1:]: v for k, v in state_dict.items()
                     if k.startswith(top + ".")}
    return tree


def has_decoder_keys(state_dict: dict) -> bool:
    """True when a state dict holds a whole recognizer: the transformer
    decoder's layer stack or char embedding, or the GRU head's decoder.  A
    bare ``decoder.`` prefix is not enough: pre-training checkpoints hold a
    SimMIM pixel decoder under that name (`dig_tpu/utils/checkpoint.py:766-776`)."""
    return any(k.startswith(("decoder.layer_stack.", "decoder.trg_word_emb.", "decoder.decoder."))
               for k in state_dict)


def merge_pretrained_tree(model, tree: dict) -> int:
    """Graft {top module: {key below it: tensor}} onto `model` in place,
    with the JAX package's rules (`merge_pretrained_tree`): a tensor of the
    model's shape is copied; one the model lacks, or has in another shape,
    is skipped with a note; a subtree of several tensors that matches
    nothing means another architecture and raises `ValueError`.  A
    ``pos_embed`` is reported unused: the ported encoders hold a fixed
    sinusoid table (`interpolate_pos_embed` waits for the learnable one).
    Returns the number of tensors copied."""
    own = model.state_dict()
    total = 0
    for top, sub in tree.items():
        grafted = 0
        for key, value in sub.items():
            name = f"{top}.{key}"
            if key == "pos_embed" and name not in own:
                print(f"skip {name}: unused, the encoder's position table is a fixed sinusoid")
            elif name not in own:
                print(f"skip missing {name}")
            elif tuple(own[name].shape) != tuple(value.shape):
                print(f"skip {name}: shape {tuple(value.shape)} vs {tuple(own[name].shape)}")
            else:
                with torch.no_grad():
                    own[name].copy_(value.to(own[name].dtype))
                grafted += 1
        if len(sub) > 1 and grafted == 0:
            raise ValueError(
                f"checkpoint subtree '{top}' ({len(sub)} tensors) matched nothing in the model: "
                f"the checkpoint and the configured model are different architectures")
        total += grafted
    return total
