"""Batch-inference entry point: weights -> recognized text, on the card.

    python -m dig_tpu_torch.cli.run_predict \
        --finetune DiG_finetuned.pth --images crops/ more/*.png \
        --output predictions.tsv

Counterpart of `dig_tpu.cli.run_predict` with the same flags and TSV
output, ``name<TAB>text<TAB>confidence``.  Confidence is the geometric mean
of the chosen-token probabilities up to the first EOS.  Runs on CUDA;
`main(cfg, device="cpu")` runs the plain versions of the kernels.

Not yet ported (each refused with a message): `--data_path` LMDB input
(the data slice), `--resume` of a native `dig_tpu` checkpoint (its
`treedef.pkl` needs JAX to unpickle: convert it with
`tools/export_pth.py` and pass the `.pth` to `--finetune`), beam search,
and model kinds other than ``rec``.
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
from dig_tpu_torch.ops import activations
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.utils.charset import build_charset

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


def _decode_resize(path: str, h: int, w: int):
    """Image file -> uint8 RGB [h, w, 3] (bicubic resize, as the JAX
    package's `resize_uint8`), or None if unreadable.  cv2 first, PIL
    second, both imported here: the card's machine has neither."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    img = None
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if img is not None:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if img.shape[:2] != (h, w):
                img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
        return img
    except ImportError:
        pass
    import io

    from PIL import Image, UnidentifiedImageError

    try:
        pil = Image.open(io.BytesIO(buf)).convert("RGB")
    except (UnidentifiedImageError, OSError):
        return None
    return np.asarray(pil.resize((w, h), Image.BICUBIC))


def iter_file_batches(paths, batch_size, h, w, num_workers: int = 4):
    """Yield (names, images [B,H,W,3] uint8) from image files; decode and
    resize run on a thread pool, a bounded chunk at a time.  Unreadable
    files are skipped with a note."""
    chunk = max(batch_size * 8, 64)
    it = iter(paths)
    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        names, imgs = [], []
        while part := list(itertools.islice(it, chunk)):
            for name, img in zip(part, pool.map(lambda p: _decode_resize(p, h, w), part)):
                if img is None:
                    print(f"[predict] skipping unreadable image {name!r}", file=sys.stderr)
                    continue
                names.append(name)
                imgs.append(img)
                if len(imgs) == batch_size:
                    yield names, np.stack(imgs)
                    names, imgs = [], []
        if imgs:
            yield names, np.stack(imgs)


def make_predict_fn(model, eos: int):
    """uint8 images [B,H,W,3] (on the model's device) -> (ids [B,T],
    confidence [B]).  Confidence is exp(mean log p) of the chosen tokens up
    to and including the first EOS (all T steps when there is none)."""

    @torch.no_grad()
    def predict(images):
        probs, ids = model.recognize(to_model_images(images), 0, eos)
        step_p = torch.gather(probs, -1, ids[..., None])[..., 0]
        t = ids.shape[1]
        is_eos = ids == eos
        eff_len = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, t)
        mask = torch.arange(t, device=ids.device)[None, :] < eff_len[:, None]
        logp = (torch.log(step_p + 1e-9) * mask).sum(dim=1) / eff_len
        return ids, torch.exp(logp)

    return predict


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
                            use_mean_pooling=cfg.use_mean_pooling, dtype=dtype,
                            model_kind=cfg.model_kind, seed=cfg.seed, device=device)
    if cfg.finetune:
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
    if cfg.resume:
        raise ValueError(
            "--resume of a native dig_tpu checkpoint directory is not supported "
            "here: its treedef.pkl unpickles only with JAX. Convert it with "
            "`python tools/export_pth.py <ckpt_dir> out.pth` and pass --finetune out.pth")
    if cfg.data_path:
        raise NotImplementedError("--data_path (LMDB input) is not ported yet; "
                                  "use --images")
    if cfg.beam_width > 0:
        raise NotImplementedError("--beam_width > 0 is not ported yet (greedy only)")
    if cfg.text_cond_vis:
        raise NotImplementedError("--text_cond_vis is not ported yet")
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
    predict_fn = make_predict_fn(model, charset.eos_id)
    batches = iter_file_batches(collect_image_paths(cfg.images), cfg.batch_size,
                                cfg.input_h, cfg.input_w, cfg.num_workers)
    sink = open(cfg.output, "w") if cfg.output else sys.stdout
    n = 0
    try:
        for names, ids, conf in predict_batches(predict_fn, batches, cfg.batch_size, device):
            for name, row, c in zip(names, ids, conf):
                sink.write(f"{name}\t{charset.decode(row)}\t{c:.4f}\n")
            n += len(names)
    finally:
        if cfg.output:
            sink.close()
    print(f"[predict] recognized {n} images", file=sys.stderr)
    return n


if __name__ == "__main__":
    main(parse_config(PredictConfig))
