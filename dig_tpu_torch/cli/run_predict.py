"""Batch-inference entry point: weights -> recognized text, on the card.

    python -m dig_tpu_torch.cli.run_predict \
        --finetune DiG_finetuned.pth --images crops/ more/*.png \
        --data_path benchmark_lmdb --output predictions.tsv

Counterpart of `dig_tpu.cli.run_predict` with the same flags and TSV
output, ``name<TAB>text<TAB>confidence``.  Inputs are image files,
directories (recursed), globs, and-or LMDBs in the reference schema
(``image-%09d`` / ``num-samples``; labels ignored), files first.
Every model kind of `dig_tpu` serves here (`--model_kind rec | ctc | attn |
seq_cls | mim_rec`, the reference spellings `--decoder_type attention`
and `--use_seq_cls_token`, `--decoder_name decoupled_tf_decoder`,
`--text_cond_vis`).  Confidence is the geometric mean of the chosen-token
probabilities up to the first EOS; under `--beam_width` the beam's ids are
rescored by one teacher-forced pass, as the JAX CLI rescores them.  A CTC
model's text is its collapsed per-frame argmax, its confidence the
geometric mean over the frames of each frame's largest probability.
Runs on CUDA; `main(cfg, device="cpu")` runs the plain versions of the
kernels.

`--resume` takes a checkpoint directory: a native `dig_tpu` one (its
params, as the JAX CLI takes them; read without JAX by
`utils/native_ckpt.py`) or the port's own; it and `--finetune` may be
remote URIs (fsspec).
"""

from __future__ import annotations

import glob
import itertools
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dig_tpu_torch.config import PredictConfig, config_to_json, parse_config
from dig_tpu_torch.data.images import decode_image, resize_uint8
from dig_tpu_torch.metrics.text import ctc_decode_batch
from dig_tpu_torch.ops import activations
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.utils import native_ckpt
from dig_tpu_torch.utils.charset import build_charset
from dig_tpu_torch.utils.checkpoint import restore_checkpoint

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif", ".tiff")


def collect_image_paths(specs) -> list:
    """Expand files / directories (recursed) / globs into a deduplicated
    list of image paths in a deterministic order."""
    def walk(d):
        for root, dirs, files in os.walk(d):
            dirs.sort()  # os.walk order is filesystem-dependent
            yield from (os.path.join(root, f) for f in sorted(files)
                        if f.lower().endswith(IMAGE_EXTS))

    out = []
    for spec in specs:
        if os.path.isdir(spec):
            out.extend(walk(spec))
        elif os.path.isfile(spec):
            out.append(spec)
        else:
            matched = sorted(glob.glob(spec, recursive=True))
            if not matched:
                print(f"[predict] no images match {spec!r}", file=sys.stderr)
            for p in matched:
                if os.path.isdir(p):
                    out.extend(walk(p))
                elif p.lower().endswith(IMAGE_EXTS) or os.path.isfile(p):
                    out.append(p)
    return list(dict.fromkeys(out))


def _decode_resize(buf, h: int, w: int):
    """Image bytes -> uint8 RGB [h, w, 3], or None if they are no image (or
    `buf` is None, a missing record): `decode_image`, then `resize_uint8`,
    which is OpenCV's bicubic, by cv2 or written out in numpy
    (`dig_tpu_torch/data/images.py`).  With neither cv2 nor PIL installed
    `decode_image` raises: nothing could be decoded at all."""
    img = decode_image(buf) if buf is not None else None
    return None if img is None else resize_uint8(img, h, w)


def _prep_batches(pairs, prep, batch_size, num_workers, what):
    """The decode-and-collect loop of the file and LMDB iterators: `pairs`
    yields (name, payload); `prep(payload)`, run on a thread pool, returns
    an image or None.  The map goes a bounded chunk at a time, so decoded
    images in memory stay O(chunk) when the model is slower than the decode
    threads.  A None result is skipped under its own name with a note."""
    chunk = max(batch_size * 8, 64)
    it = iter(pairs)
    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        names, imgs = [], []
        while part := list(itertools.islice(it, chunk)):
            for (name, _), img in zip(part, pool.map(prep, [p for _, p in part])):
                if img is None:
                    print(f"[predict] skipping unreadable {what} {name!r}", file=sys.stderr)
                    continue
                names.append(name)
                imgs.append(img)
                if len(imgs) == batch_size:
                    yield names, np.stack(imgs)
                    names, imgs = [], []
        if imgs:
            yield names, np.stack(imgs)


def iter_file_batches(paths, batch_size, h, w, num_workers: int = 4):
    """Yield (names, images [B,H,W,3] uint8) from image files; reading,
    decode and resize all run on the pool.  Unreadable files are skipped
    with a note."""

    def load(path):
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except OSError:
            return None
        return _decode_resize(buf, h, w)

    yield from _prep_batches(((p, p) for p in paths), load, batch_size, num_workers, "image")


def iter_lmdb_batches(data_paths, batch_size, cfg, num_workers: int = 4):
    """Yield (names, images) batches from LMDBs in the reference schema
    (``image-%09d`` / ``num-samples``).  Records are read by index: labels
    are never touched (unlabeled LMDBs work), and a corrupt or missing
    record is skipped under its own name ``{path}#{i}``, never replaced by a
    neighbour, which would put a prediction under the wrong name.

    Records are fetched on the main thread (the `lmdb`-package backend
    shares one transaction, which threads must not share; `_prep_batches`
    pulls the lazy `pairs` a chunk at a time); decode and resize run on the
    pool."""
    from dig_tpu_torch.data.lmdb_store import LmdbReader

    def prep(buf):
        return _decode_resize(buf, cfg.input_h, cfg.input_w)

    for path in data_paths:
        reader = LmdbReader(path)
        try:
            print(f"[predict] reading {path!r} with the {reader.backend} LMDB backend",
                  file=sys.stderr)
            n_raw = reader.get(b"num-samples")
            if n_raw is None:
                raise ValueError(f"{path!r} has no 'num-samples' key: not an LMDB in the "
                                 f"reference schema (tools/create_lmdb.py writes it)")
            pairs = ((f"{path}#{i}", reader.get(b"image-%09d" % i))
                     for i in range(1, int(n_raw) + 1))
            yield from _prep_batches(pairs, prep, batch_size, num_workers, "record")
        finally:
            reader.close()


def make_predict_fn(model, eos: int, beam_width: int = 0, ctc: bool = False):
    """uint8 images [B,H,W,3] (on the model's device) -> (ids [B,T],
    confidence [B]).  Confidence is exp(mean log p) of the chosen tokens up
    to and including the first EOS (all T steps when there is none).  Beam
    search (`beam_width` > 0) returns ids only; their probabilities come
    from one teacher-forced pass over them, the sequence's exact softmax
    chain (`dig_tpu/cli/run_predict.py:174-185`).  `ctc`: the per-frame
    argmax and exp(mean log) of each frame's largest probability (:158-170)."""

    @torch.no_grad()
    def predict_ctc(images):
        logits = model(to_model_images(images), deterministic=True).float()
        top = torch.softmax(logits, dim=-1).max(dim=-1)
        return top.indices, torch.exp(torch.log(top.values + 1e-9).mean(dim=-1))

    @torch.no_grad()
    def predict(images):
        x = to_model_images(images)
        probs, ids = model.recognize(x, beam_width, eos)
        if probs is None:
            lens = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.long, device=ids.device)
            logits = model(x, ids, lens, deterministic=True)
            if isinstance(logits, dict):  # MimRecModel
                logits = logits["rec_pred"]
            elif isinstance(logits, tuple):  # SeqClsRecModel
                logits = logits[0]
            probs = torch.softmax(logits.float(), dim=-1)
        step_p = torch.gather(probs, -1, ids[..., None])[..., 0]
        t = ids.shape[1]
        is_eos = ids == eos
        eff_len = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, t)
        mask = torch.arange(t, device=ids.device)[None, :] < eff_len[:, None]
        logp = (torch.log(step_p + 1e-9) * mask).sum(dim=1) / eff_len
        return ids, torch.exp(logp)

    return predict_ctc if ctc else predict


def predict_batches(predict_fn, batches, batch_size: int, device):
    """Run already-decoded uint8 batches through `predict_fn`; yields
    (names, ids [b,T] numpy, confidence [b] numpy) per batch.  A short
    last batch is padded to `batch_size`, as the JAX CLI does, so every
    batch has the same shapes.  Each batch's results are read back after
    the next batch is queued, so host work overlaps the card's."""
    pending = None
    for names, images in batches:
        b = images.shape[0]
        if b < batch_size:
            pad = np.zeros((batch_size - b, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad])
        ids, conf = predict_fn(torch.from_numpy(images).to(device, non_blocking=True))
        if pending is not None:
            yield _fetch(*pending)
        pending = (names, b, ids, conf)
    if pending is not None:
        yield _fetch(*pending)


def _fetch(names, b, ids, conf):
    return names, ids[:b].cpu().numpy(), conf[:b].float().cpu().numpy()


def load_model(cfg: PredictConfig, device):
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.utils.convert import load_pth

    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = build_rec_model(cfg.model, cfg.decoder_name, cfg.nb_classes, cfg.max_len,
                            use_1d_attdec=cfg.use_1d_attdec,
                            use_mean_pooling=cfg.use_mean_pooling,
                            use_feat_distill=cfg.use_feat_distill,
                            text_cond_vis=cfg.text_cond_vis, dtype=dtype,
                            model_kind=cfg.model_kind, seed=cfg.seed, device=device)
    if cfg.resume:  # a whole recognizer's weights, as dig_tpu takes them (no surgery)
        payload = restore_checkpoint(cfg.resume)
        model.load_state_dict(native_ckpt.model_state_dict(payload["native"], False)
                              if "native" in payload else payload["model"])
    elif cfg.finetune:
        sd = load_pth(cfg.finetune, cfg.model_key, cfg.model_prefix)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        if missing:
            raise KeyError(f"{cfg.finetune}: missing weights {missing[:8]} "
                           f"({len(missing)} in all)")
        if unexpected:
            print(f"[predict] ignoring {len(unexpected)} keys with no counterpart, "
                  f"e.g. {unexpected[:4]}", file=sys.stderr)
    else:
        print("[predict] WARNING: no --resume/--finetune given; "
              "predicting with randomly initialized weights", file=sys.stderr)
    return model


def main(cfg: PredictConfig, device="cuda"):
    if not cfg.images and not cfg.data_path:
        raise SystemExit("run_predict: provide --images and/or --data_path")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_predict runs on CUDA and no card is visible; "
                           "call main(cfg, device='cpu') for the CPU")
    print(config_to_json(cfg), file=sys.stderr)

    activations.set_exact(activations.resolve_exact_gelu(cfg.exact_gelu, (cfg.finetune,)))
    charset = build_charset(cfg.voc_type, cfg.max_len)
    if charset.num_classes != cfg.nb_classes:
        raise ValueError(f"--voc_type {cfg.voc_type} has {charset.num_classes} "
                         f"classes, --nb_classes is {cfg.nb_classes}")
    model = load_model(cfg, device)
    ctc = cfg.model_kind == "ctc"
    predict_fn = make_predict_fn(model, charset.eos_id, cfg.beam_width, ctc)
    if ctc:
        decode = lambda ids: ctc_decode_batch(ids, charset)  # noqa: E731
    else:
        decode = lambda ids: [charset.decode(row) for row in ids]  # noqa: E731

    def batches():  # files first, then the LMDBs, as the JAX CLI orders them
        if cfg.images:
            yield from iter_file_batches(collect_image_paths(cfg.images), cfg.batch_size,
                                         cfg.input_h, cfg.input_w, cfg.num_workers)
        if cfg.data_path:
            yield from iter_lmdb_batches(cfg.data_path, cfg.batch_size, cfg, cfg.num_workers)

    sink = open(cfg.output, "w") if cfg.output else sys.stdout
    n = 0
    try:
        for names, ids, conf in predict_batches(predict_fn, batches(), cfg.batch_size, device):
            for name, text, c in zip(names, decode(ids), conf):
                sink.write(f"{name}\t{text}\t{c:.4f}\n")
            n += len(names)
    finally:
        if cfg.output:
            sink.close()
    print(f"[predict] recognized {n} images", file=sys.stderr)
    return n


if __name__ == "__main__":
    main(parse_config(PredictConfig))
