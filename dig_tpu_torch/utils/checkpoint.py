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

Across data-parallel ranks `save_checkpoint` and `prune_checkpoints` are
collectives: every rank calls them at the same point, rank 0 alone writes
or deletes, and the others wait at a barrier until it has; so every rank
that then lists `output_dir` (`--auto_resume`) or reads a path
(`--resume`) finds the same checkpoint.  Under a mesh that shards the
parameters (`parallel/sharding.py`) every rank first gathers its pieces of
the parameters and of the optimizer state (`full_state_dict`, the
optimizer's `state_dict`), so rank 0 writes the whole tensors: the file is
the one an unsharded run writes, byte for byte in its layout, and it
restores into any mesh, each rank taking its pieces.

Restoring puts back everything a step reads: the parameters, the momentum
modules, AdamW's moments and step tensors, the optimizer's schedule index
`count` and `state.step`.  Restore *after* `init_pretrain_state`, which
resets the momentum branch to the student.

Weights from elsewhere (`dig_tpu/utils/checkpoint.py:375-414, 542-906`),
as state-dict operations on the reference key layout that the port's
models use: `load_torch_checkpoint` (the ``--model_key`` order),
`convert_torch_encoder` (the prefix order), `convert_torch_attn_head` (the
GRU head), `convert_torch_recognizer`, `has_decoder_keys`, and
`merge_pretrained_tree`, which grafts what fits onto a model and fits a
learnable ``pos_embed`` of another grid with `interpolate_pos_embed`.

Every function that takes a path also takes a remote URI (``gs://...``,
``s3://...``, ``memory://...``; `dig_tpu/utils/checkpoint.py:64-83,
212-264`): its files go through fsspec, which is imported only for such a
path (a local run never imports it; without it installed a remote path
raises a message naming it).  A remote checkpoint is written in place,
with no temporary name (object stores have no atomic rename): its
``meta.json``, written last, is still the commit marker.

`restore_checkpoint` also reads the JAX package's native directories
(``arrays.npz`` + ``treedef.pkl``, `dig_tpu/utils/checkpoint.py:85-112,
184-209`), without JAX (`utils/native_ckpt.py`): the payload then holds
the saved trees under "native", which `load_into_state` carries into the
port's layout.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from dig_tpu_torch.parallel.dist import barrier, is_main_process
from dig_tpu_torch.parallel.sharding import full_state_dict, load_full_state_dict
from dig_tpu_torch.utils import native_ckpt

PAYLOAD = "checkpoint.pth"


def is_remote(path: str) -> bool:
    return "://" in path


def _fs(path: str):
    """(fsspec filesystem, path on it) of a remote URI; fsspec is imported
    here only."""
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(f"{path} is a remote checkpoint URI, which needs the fsspec "
                          f"package (and its protocol's implementation); it is not "
                          f"installed") from e
    return fsspec.core.url_to_fs(path)


def _join(base: str, *parts: str) -> str:
    if is_remote(base):
        return "/".join([base.rstrip("/"), *parts])
    return os.path.join(base, *parts)


def _exists(path: str) -> bool:
    if is_remote(path):
        fs, root = _fs(path)
        return fs.exists(root)
    return os.path.exists(path)


def read_bytes(path: str) -> bytes:
    """A file's bytes, local or remote."""
    if is_remote(path):
        fs, root = _fs(path)
        with fs.open(root, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, name: str, write) -> None:
    """write(binary file) into ``path/name``: locally under a temporary
    name, then renamed onto it; remotely in place."""
    if is_remote(path):
        fs, root = _fs(path)
        with fs.open(f"{root}/{name}", "wb") as f:
            write(f)
        return
    tmp = os.path.join(path, "tmp_" + name)
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, os.path.join(path, name))


def save_checkpoint(output_dir: str, tag, state, extra: Optional[dict] = None) -> str:
    """Write ``{output_dir}/checkpoint-{tag}`` from a `TrainState` (rank 0;
    every rank returns after it has); returns its path."""
    if is_remote(output_dir):
        path = _join(output_dir, f"checkpoint-{tag}")
    else:
        path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{tag}"))
    # every rank: the sharded pieces are gathered collectively
    payload = {"model": full_state_dict(state.model), "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}
    if is_main_process():
        _write_checkpoint(path, payload, extra)
    barrier()
    return path


def _write_checkpoint(path: str, payload: dict, extra: Optional[dict]) -> None:
    if is_remote(path):
        fs, root = _fs(path)
        fs.makedirs(root, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)
    _write(path, PAYLOAD, lambda f: torch.save(payload, f))
    meta = {"step": payload["step"]}
    if extra:
        meta["extra"] = extra
    _write(path, "meta.json", lambda f: f.write(json.dumps(meta).encode()))  # last: the commit marker


def restore_checkpoint(path: str) -> dict:
    """Load a checkpoint directory onto the CPU: the payload's keys plus
    "step" and, where the save gave one, "extra" from ``meta.json``; for a
    native `dig_tpu` directory, its trees under "native" (`native_ckpt`)."""
    if not is_remote(path):
        path = os.path.abspath(path)
    if _exists(_join(path, "arrays.npz")):
        return native_ckpt.read_native(lambda name: read_bytes(_join(path, name)))
    pth = _join(path, PAYLOAD)
    payload = torch.load(io.BytesIO(read_bytes(pth)) if is_remote(pth) else pth,
                         map_location="cpu", weights_only=True)
    meta = json.loads(read_bytes(_join(path, "meta.json")).decode())
    payload["step"] = meta["step"]
    if "extra" in meta:
        payload["extra"] = meta["extra"]
    return payload


def load_into_state(state, payload: dict):
    """Put a restored payload into `state`, in place: model (student and
    momentum modules), the optimizer's state (`state_dict()`: AdamW's
    moments and step tensors, or the other rules' state), the schedule
    index and the step counter.  Returns `state`.  A native payload goes
    through `native_ckpt.load_into_state`.

    Only the optimizer's per-parameter state is taken from the file.  Its
    hyper-parameters (betas, eps, the groups' lr scales) stay those the
    optimizer was built with, as in the JAX package, whose optimizer state
    holds none: the flags of the resuming run decide."""
    if "native" in payload:
        return native_ckpt.load_into_state(state, payload)
    load_full_state_dict(state.model, payload["model"])  # a sharded parameter takes its piece
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def _list_dir_names(output_dir: str) -> Optional[list]:
    """Entry names directly under `output_dir` (local or remote); None when
    it does not exist."""
    if is_remote(output_dir):
        fs, root = _fs(output_dir)
        try:
            return [p.rstrip("/").rsplit("/", 1)[-1] for p in fs.ls(root, detail=False)]
        except FileNotFoundError:
            return None
    return os.listdir(output_dir) if os.path.isdir(output_dir) else None


def _numbered(output_dir: str) -> list:
    """[(N, name)] of the ``checkpoint-N`` entries under `output_dir`, ascending."""
    return sorted((int(m.group(1)), n) for n in _list_dir_names(output_dir) or []
                  if (m := re.fullmatch(r"checkpoint-(\d+)", n)))


def numeric_checkpoints(output_dir: str) -> list:
    """Complete (meta.json-bearing) ``checkpoint-N`` paths, newest first."""
    return [_join(output_dir, n) for _, n in reversed(_numbered(output_dir))
            if _exists(_join(output_dir, n, "meta.json"))]


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The highest-numbered complete ``checkpoint-N`` directory, or None."""
    paths = numeric_checkpoints(output_dir)
    return paths[0] if paths else None


def prune_checkpoints(output_dir: str, keep: int) -> list:
    """Delete the oldest numeric ``checkpoint-N`` directories beyond the
    newest `keep` (0 or negative keeps all, the reference's behaviour);
    returns the names deleted (rank 0 deletes; every rank returns after it
    has).  Other tags are never touched."""
    if keep <= 0:
        return []
    numbered = _numbered(output_dir)
    pruned = [name for _, name in (numbered[:-keep] if keep < len(numbered) else [])]
    if is_main_process():
        for name in pruned:
            if is_remote(output_dir):
                fs, root = _fs(output_dir)
                try:
                    fs.rm(f"{root}/{name}", recursive=True)
                except FileNotFoundError:
                    pass
            else:
                shutil.rmtree(os.path.join(output_dir, name), ignore_errors=True)
    barrier()
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

# the encoder tensors `dig_tpu/utils/checkpoint.py::convert_torch_encoder` maps,
# which are those `dig_tpu/utils/export_torch.py::export_torch_encoder` writes
ENCODER_KEY = re.compile(
    r"patch_embed\.proj\.(weight|bias)|mask_token|pos_embed|(fc_)?norm\.(weight|bias)"
    r"|blocks\.\d+\.(attn\.(qkv\.weight|q_bias|v_bias|proj\.(weight|bias))"
    r"|norm[12]\.(weight|bias)|mlp\.fc[12]\.(weight|bias)|gamma_[12])")


def load_torch_checkpoint(path: str, model_key: str = "model|module") -> dict:
    """A `.pth` -> its state dict of tensors.  `model_key` is the
    reference's ``--model_key``, a '|'-separated list of candidate
    top-level keys tried in order (run_class_finetuning.py:372-377), with
    ``state_dict`` tried last; a file with none of them is the state dict
    itself.  Unpickling is restricted to tensors, containers and the
    argparse namespace the reference stores beside them.  `path` may be a
    remote URI."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(io.BytesIO(read_bytes(path)) if is_remote(path) else path,
                          map_location="cpu", weights_only=True)
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
    return {k: v for k, v in sd.items() if ENCODER_KEY.fullmatch(k)}


def convert_torch_attn_head(state_dict: dict, prefix: str = "decoder.") -> dict:
    """The reference GRU head's tensors (models/attn_decoder.py:203-279:
    ``decoder.attention_unit.{sEmbed,xEmbed,wEmbed}``, ``decoder.tgt_embedding``,
    ``decoder.gru.*``, ``decoder.fc``), keyed below `prefix`.  The port's
    head keeps torch's layout, biases included, so the tensors pass as
    they are."""
    head = ("decoder.attention_unit.", "decoder.tgt_embedding.", "decoder.gru.", "decoder.fc.")
    sub = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    return {k: v for k, v in sub.items() if k.startswith(head)}


def convert_torch_recognizer(state_dict: dict) -> dict:
    """A fine-tuned reference recognizer's state dict -> {"encoder": ...,
    "linear_norm": ..., "decoder": ...}, each keyed below its module: the
    GRU head's tensors when it has them (`convert_torch_attn_head`), else
    the transformer decoder's.  A subtree the file lacks is left out."""
    tree = {"encoder": convert_torch_encoder(state_dict, prefix="encoder.")}
    tree["linear_norm"] = {k[len("linear_norm."):]: v for k, v in state_dict.items()
                           if k.startswith("linear_norm.")}
    if any(k.startswith("decoder.decoder.gru.") for k in state_dict):
        tree["decoder"] = convert_torch_attn_head(state_dict)
    else:
        tree["decoder"] = {k[len("decoder."):]: v for k, v in state_dict.items()
                           if k.startswith("decoder.")}
    return {top: sub for top, sub in tree.items() if sub}


def has_decoder_keys(state_dict: dict) -> bool:
    """True when a state dict holds a whole recognizer: the transformer
    decoder's layer stack or char embedding, or the GRU head's decoder.  A
    bare ``decoder.`` prefix is not enough: pre-training checkpoints hold a
    SimMIM pixel decoder under that name (`dig_tpu/utils/checkpoint.py:766-776`)."""
    return any(k.startswith(("decoder.layer_stack.", "decoder.trg_word_emb.", "decoder.decoder."))
               for k in state_dict)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of JAX's cubic image resize along one axis:
    Keys' cubic (a = -0.5), half-pixel centres, the kernel widened by the
    scale when shrinking (antialiasing), each column normalized, and zero
    where the sample falls outside the input."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)


def interpolate_pos_embed(pos, new_grid, old_grid=None, num_extra_tokens: int = 0):
    """Bicubic re-interpolation of a learnable position embedding
    [1, extra + gh * gw, D] onto `new_grid` (reference
    run_class_finetuning.py:403-424; `dig_tpu/utils/checkpoint.py:779-813`).
    The reference assumes a square grid, which DiG's 8 x 32 is not: the old
    grid is inferred with the new grid's aspect ratio, else square.  The
    resize is JAX's cubic image resize (`_cubic_weights`), computed in
    float64 here; the extra tokens are kept."""
    pos = np.asarray(pos, dtype=np.float32)
    d = pos.shape[-1]
    extra, tok = pos[:, :num_extra_tokens], pos[:, num_extra_tokens:]
    n_old = tok.shape[1]
    if old_grid is None:
        h = int(round((n_old * new_grid[0] / new_grid[1]) ** 0.5)) or 1
        old_grid = (h, n_old // h)
        if old_grid[0] * old_grid[1] != n_old:
            s = int(round(n_old**0.5))
            if s * s != n_old:
                raise ValueError(f"cannot infer a {new_grid[0]}:{new_grid[1]} grid from "
                                 f"{n_old} position tokens")
            old_grid = (s, s)
    print(f"Position interpolate from {old_grid[0]}x{old_grid[1]} "
          f"to {new_grid[0]}x{new_grid[1]}")
    grid = tok.reshape(*old_grid, d).astype(np.float64)
    if tuple(old_grid) != tuple(new_grid):
        grid = np.einsum("hwd,hH,wW->HWd", grid, _cubic_weights(old_grid[0], new_grid[0]),
                         _cubic_weights(old_grid[1], new_grid[1]))
    out = grid.reshape(1, new_grid[0] * new_grid[1], d).astype(np.float32)
    return np.concatenate([extra, out], axis=1) if num_extra_tokens else out


def _fit_pos_embed(src, dst, grid):
    """A source pos_embed refitted onto the destination's grid, or None.  The
    extra (non-grid) tokens are counted per side (`dig_tpu/utils/checkpoint.py:816-846`):
    the destination's from its shape, the source's by the split whose grid
    can be inferred (the destination's count first, then 0); rows the
    source lacks keep the destination's own values."""
    n_grid = grid[0] * grid[1]
    extra_dst = dst.shape[1] - n_grid
    for extra_src in dict.fromkeys((max(extra_dst, 0), 0)):
        if src.shape[1] - extra_src <= 0:
            continue
        try:
            fitted = interpolate_pos_embed(src, grid, num_extra_tokens=extra_src)
        except ValueError:
            continue
        if extra_src < extra_dst:
            fitted = np.concatenate([dst.numpy()[:, : extra_dst - extra_src], fitted], axis=1)
        return torch.from_numpy(fitted)
    return None


def merge_pretrained_tree(model, tree: dict, pos_embed_grid=None) -> int:
    """Graft {top module: {key below it: tensor}} onto `model` in place,
    with the JAX package's rules (`merge_pretrained_tree`): a tensor of the
    model's shape is copied; a ``pos_embed`` of another shape is refitted
    onto `pos_embed_grid` (the model's (gh, gw)) by `interpolate_pos_embed`;
    one the model lacks, or has in another shape, is skipped with a note (a
    ``pos_embed`` the encoder has no place for is reported unused: its
    position table is a fixed sinusoid); a subtree of several tensors that
    matches nothing means another architecture (a transformer decoder's
    `.pth` into ``--model_kind attn``, say) and raises `ValueError`.
    Returns the number of tensors copied."""
    own = model.state_dict()
    total = 0
    for top, sub in tree.items():
        grafted = 0
        for key, value in sub.items():
            name = f"{top}.{key}"
            if key == "pos_embed" and name not in own:
                print(f"skip {name}: unused, the encoder's position table is a fixed sinusoid")
                continue
            if name not in own:
                print(f"skip missing {name}")
                continue
            if tuple(own[name].shape) != tuple(value.shape):
                fitted = None
                if (key == "pos_embed" and pos_embed_grid is not None and value.dim() == 3
                        and value.shape[-1] == own[name].shape[-1]):
                    fitted = _fit_pos_embed(value.float(), own[name].cpu().float(),
                                            pos_embed_grid)
                if fitted is None:
                    print(f"skip {name}: shape {tuple(value.shape)} vs "
                          f"{tuple(own[name].shape)}")
                    continue
                value = fitted
            with torch.no_grad():
                own[name].copy_(value.to(own[name].dtype))
            grafted += 1
        if len(sub) > 1 and grafted == 0:
            raise ValueError(
                f"checkpoint subtree '{top}' ({len(sub)} tensors) matched nothing in the model: "
                f"the checkpoint and the configured model are different architectures")
        total += grafted
    return total
