"""Checkpoints of the port: save, restore, auto-resume, pruning.

The semantics are those of `dig_tpu/utils/checkpoint.py` (reference:
utils/utils.py:546-669); the payload is the port's own.

* A checkpoint is a directory ``{output_dir}/checkpoint-{tag}`` holding
  ``checkpoint.pth`` and ``meta.json``.
* ``checkpoint.pth`` is one `torch.save` of ``{"model": state_dict,
  "optimizer": {"inner": torch.optim.AdamW state_dict, "count": int},
  "step": int}``, written to a temporary name and renamed.  The state dict
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

Not ported yet (see ROADMAP.md): remote URIs (``gs://...`` through fsspec)
and reading the JAX package's native directories (``arrays.npz`` +
``treedef.pkl``); both are refused with a message.
"""

from __future__ import annotations

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
    payload = {"model": state.model.state_dict(),
               "optimizer": {"inner": state.optimizer.inner.state_dict(),
                             "count": int(state.optimizer.count)},
               "step": int(state.step)}
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
