"""Create recognition LMDB datasets in the reference schema.

The port's copy of `tools/create_lmdb.py`, on `dig_tpu_torch`'s LMDB writer:
the same arguments, the same bytes, no JAX.

Equivalent of the reference's `createDataset` family
(tools/create_mae_lmdb.py:37-85, create_iam_lmdb.py, create_cvl_lmdb.py,
create_iam_lmdb_from_fullImg.py, create_opentext_lmdb.py): keys
``image-%09d`` (raw encoded image bytes), ``label-%09d`` (utf-8 text) and
``num-samples``.  Uses the framework's native LMDB writer, so no liblmdb
is needed.

Usage:
    python -m dig_tpu_torch.tools.create_lmdb OUTPUT_LMDB --list labels.txt [--root DIR]
        # labels.txt lines: <relative/image/path>\t<label>
    python -m dig_tpu_torch.tools.create_lmdb OUTPUT_LMDB --images img1.jpg img2.jpg \
        --labels word1 word2

Dataset-specific annotation parsers (the reference hardcodes its own
paths; here they are flags):

    # IAM handwriting (words/ crops + ascii/words.txt + splits/*.txt;
    # reference create_iam_lmdb.py:99-124)
    python -m dig_tpu_torch.tools.create_lmdb OUT --dataset iam --root IAM/words \
        --annot IAM/ascii/words.txt --split IAM/splits/trainset.txt

    # IAM re-cropped from the full page scans (crops written next to the
    # LMDB; reference create_iam_lmdb_from_fullImg.py:101-155)
    python -m dig_tpu_torch.tools.create_lmdb OUT --dataset iam_fullimg --root IAM/images \
        --annot IAM/ascii/words.txt --split IAM/splits/trainset.txt \
        --crop_dir IAM/cropped_images

    # CVL handwriting (label embedded in the file name
    # '0053-1-0-0-Imagine.tif'; reference create_cvl_lmdb.py:91-104)
    python -m dig_tpu_torch.tools.create_lmdb OUT --dataset cvl --root cvl/trainset/words

    # OpenImages text crops, unlabeled ('###'); reference
    # create_opentext_lmdb.py:84-93
    python -m dig_tpu_torch.tools.create_lmdb OUT --dataset opentext --root open_images \
        --subdirs training_1_set training_2_set validation_set
"""

from __future__ import annotations

import argparse
import os

from dig_tpu_torch.data.lmdb_store import LmdbWriter


def check_image_valid(buf: bytes) -> bool:
    try:
        import cv2
        import numpy as np

        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_GRAYSCALE)
        return img is not None and img.shape[0] > 0 and img.shape[1] > 0
    except Exception:
        return False


def create_dataset(output_path: str, image_paths, labels, check_valid: bool = True):
    assert len(image_paths) == len(labels)
    cnt = 1
    with LmdbWriter(output_path) as w:
        for path, label in zip(image_paths, labels):
            if not label:
                continue
            if not os.path.exists(path):
                print(f"{path} does not exist")
                continue
            with open(path, "rb") as f:
                buf = f.read()
            if check_valid and not check_image_valid(buf):
                print(f"{path} is not a valid image")
                continue
            w.put(b"image-%09d" % cnt, buf)
            w.put(b"label-%09d" % cnt, label.encode())
            if cnt % 1000 == 0:
                print(f"processed {cnt}")
            cnt += 1
        n = cnt - 1
        w.put(b"num-samples", str(n).encode())
    print(f"Created dataset with {n} samples at {output_path}")
    return n


def _parse_iam_words(annot_path: str, split_path: str):
    """IAM ascii/words.txt lines:
    ``<id> <ok|err> <graylevel> <x> <y> <w> <h> <tag> <label>``; a sample is
    kept when its segmentation is 'ok' and its line id is in the split
    (reference create_iam_lmdb.py:108-122)."""
    with open(split_path) as f:
        split_ids = {line.strip() for line in f if line.strip()}
    entries = []
    with open(annot_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(" ", 8)
            if len(parts) < 9:
                continue
            image_name, seg_flag, _, x, y, w, h, _tag, label = parts
            if seg_flag != "ok":
                continue
            ids = image_name.split("-")
            if "-".join(ids[:3]) in split_ids:
                entries.append((image_name, (int(x), int(y), int(w), int(h)), label))
    return entries


def iam_lists(root: str, annot_path: str, split_path: str):
    """words/<paper>/<line>/<id>.png crops (reference create_iam_lmdb.py)."""
    paths, labels = [], []
    for image_name, _loc, label in _parse_iam_words(annot_path, split_path):
        ids = image_name.split("-")
        paths.append(os.path.join(root, ids[0], "-".join(ids[:2]), image_name + ".png"))
        labels.append(label)
    return paths, labels


def iam_fullimg_lists(root: str, annot_path: str, split_path: str, crop_dir: str):
    """Crop word boxes out of the full page scans into `crop_dir`, then
    build the lists against the crops (reference
    create_iam_lmdb_from_fullImg.py:101-155)."""
    import cv2

    entries = _parse_iam_words(annot_path, split_path)
    os.makedirs(crop_dir, exist_ok=True)
    by_page = {}
    for image_name, loc, label in entries:
        ids = image_name.split("-")
        by_page.setdefault("-".join(ids[:2]), []).append((image_name, loc, label))
    paths, labels = [], []
    for page_id, items in by_page.items():
        page = cv2.imread(os.path.join(root, page_id + ".png"))
        for image_name, (x, y, w, h), label in items:
            out = os.path.join(crop_dir, image_name + ".png")
            if page is not None and not os.path.exists(out):
                crop = page[y : y + h, x : x + w]
                if crop.size > 0:
                    cv2.imwrite(out, crop)
            paths.append(out)
            labels.append(label)
    return paths, labels


def cvl_lists(root: str):
    """CVL words/: per-writer dirs of '0053-1-0-0-Imagine.tif' files — the
    label is the 5th dash field of the stem (reference
    create_cvl_lmdb.py:91-102).  Labels with umlauts are dropped there via
    a filter; replicated here."""
    paths, labels = [], []
    for paper_dir in sorted(os.listdir(root)):
        full = os.path.join(root, paper_dir)
        if not os.path.isdir(full):
            continue
        for image_name in sorted(os.listdir(full)):
            label = os.path.splitext(image_name)[0].split("-", 4)[-1]
            if any(c in label for c in "äüö"):
                continue
            paths.append(os.path.join(full, image_name))
            labels.append(label)
    return paths, labels


def opentext_lists(root: str, subdirs):
    """Unlabeled OpenImages text crops: every .jpg under the given subdirs,
    label '###' (reference create_opentext_lmdb.py:84-92)."""
    paths = []
    for sub in subdirs:
        folder = os.path.join(root, sub)
        paths += [
            os.path.join(folder, n)
            for n in sorted(os.listdir(folder))
            if os.path.splitext(n)[-1] == ".jpg"
        ]
    return paths, ["###"] * len(paths)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--dataset", choices=["iam", "iam_fullimg", "cvl", "opentext"],
                    help="dataset-specific annotation parser (default: generic)")
    ap.add_argument("--list", help="tsv file: image_path<TAB>label")
    ap.add_argument("--root", default="", help="image root / prefix for relative paths")
    ap.add_argument("--annot", help="IAM ascii/words.txt")
    ap.add_argument("--split", help="IAM splits/<set>.txt")
    ap.add_argument("--crop_dir", help="iam_fullimg: where word crops are written")
    ap.add_argument("--subdirs", nargs="*",
                    default=["training_1_set", "training_2_set", "training_5_set",
                             "training_f_set", "validation_set"],
                    help="opentext: image subfolders to include")
    ap.add_argument("--images", nargs="*", default=[])
    ap.add_argument("--labels", nargs="*", default=[])
    ap.add_argument("--no_check", action="store_true")
    args = ap.parse_args()

    if args.dataset == "iam":
        paths, labels = iam_lists(args.root, args.annot, args.split)
    elif args.dataset == "iam_fullimg":
        paths, labels = iam_fullimg_lists(args.root, args.annot, args.split,
                                          args.crop_dir or args.root + "_crops")
    elif args.dataset == "cvl":
        paths, labels = cvl_lists(args.root)
    elif args.dataset == "opentext":
        paths, labels = opentext_lists(args.root, args.subdirs)
    elif args.list:
        paths, labels = [], []
        with open(args.list) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                p, _, label = line.partition("\t")
                paths.append(os.path.join(args.root, p))
                labels.append(label)
    else:
        paths = [os.path.join(args.root, p) for p in args.images]
        labels = args.labels
    create_dataset(args.output, paths, labels, check_valid=not args.no_check)


if __name__ == "__main__":
    main()
