"""Generic image-folder dataset with retry-on-error semantics.

The port's own copy of `dig_tpu/data/folder.py`.  Parity target:
`ImageFolder`/`DatasetFolder`
(reference: dataset/dataset_folder.py:73-245): class-per-subdirectory
layout, extension filtering, and the retry-on-random-index behavior for
corrupt files (:158-165)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dig_tpu_torch.data.images import decode_image, resize_uint8
from dig_tpu_torch.data.pipeline import ThreadLocalRng

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


class ImageFolder:
    def __init__(self, root: str, img_height: int = 32, img_width: int = 128,
                 transform=None, rng: Optional[np.random.Generator] = None):
        self.root = root
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for base, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(base, fname),
                                             self.class_to_idx[c]))
        if not classes:  # flat folder of images, no labels
            for base, _, files in sorted(os.walk(root)):
                for fname in sorted(files):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(base, fname), -1))
        self.img_height, self.img_width = img_height, img_width
        self.transform = transform
        self.rng = ThreadLocalRng(rng if rng is not None else np.random.default_rng())

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        for _ in range(16):
            path, target = self.samples[index]
            try:
                with open(path, "rb") as f:
                    img = decode_image(f.read())
                if img is None:
                    raise IOError(path)
                if self.transform is not None:
                    img = self.transform(img)
                img = resize_uint8(img, self.img_height, self.img_width)
                return img, np.int32(target)
            except Exception:
                # retry a random index (reference: dataset_folder.py:158-165)
                index = int(self.rng.integers(0, len(self)))
        raise RuntimeError(f"too many corrupt files under {self.root}")
