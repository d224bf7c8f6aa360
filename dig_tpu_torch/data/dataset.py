"""Datasets over the LMDB store.

The port's own copy of `dig_tpu/data/dataset.py`, on the port's
`LmdbReader`, `decode_image` and `resize_uint8`: with the same seed the
items are the JAX package's, byte for byte.  Every dataset has `__len__`
and `__getitem__`, so it is a map-style dataset to torch as well.

Parity targets:

* `ImageLmdb` (labeled; reference: dataset/dataset_lmdb.py:18-219):
  JPEG bytes at ``image-%09d``, text at ``label-%09d``, count at
  ``num-samples``; vocabulary built from `voc_type`; too-long words and
  corrupt images skipped by advancing to the next index; optional ABINet
  or SeqCLR augmentation.
* `AloneImageLmdb` (unlabeled pre-training; dataset/dataset_image.py:22-160):
  returns (original view, augmented view, per-view random masks).
* `ConcatDataset` (dataset/concatdatasets.py:10-56): bisect index routing,
  unified max_len/vocab.
* dataset factories (dataset/datasets.py:52-123).
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence

import numpy as np

from dig_tpu_torch.data.images import decode_image, resize_uint8
from dig_tpu_torch.data.lmdb_store import LmdbReader
from dig_tpu_torch.data.masking import RandomMaskingGenerator
from dig_tpu_torch.data.pipeline import ThreadLocalRng
from dig_tpu_torch.data.transforms import ABIAugment, SeqCLRAugment
from dig_tpu_torch.utils.charset import build_charset


class _ReopensInChild:
    """Pickles as its constructor arguments, so that a process worker
    rebuilds the dataset and opens its own LMDB reader (a native handle
    does not pickle).  The rng wrapper pickles as its base stream, and one
    shared by several datasets stays shared."""

    def __getstate__(self):
        return self._init_args

    def __setstate__(self, state):
        self.__init__(**state)


class ImageLmdb(_ReopensInChild):
    """Labeled recognition dataset.

    `__getitem__` returns (image [H,W,3] uint8, label [max_len] int32,
    label_len int32).
    """

    def __init__(
        self,
        root: str,
        voc_type: str = "ALLCASES_SYMBOLS",
        max_len: int = 25,
        num_samples: float = np.inf,
        img_height: int = 32,
        img_width: int = 128,
        use_aug: bool = False,
        use_abi_aug: bool = False,
        use_color_aug: bool = False,
        rng: Optional[np.random.Generator] = None,
    ):
        if not isinstance(rng, ThreadLocalRng):
            rng = ThreadLocalRng(rng if rng is not None else np.random.default_rng())
        self._init_args = dict(root=root, voc_type=voc_type, max_len=max_len,
                               num_samples=num_samples, img_height=img_height,
                               img_width=img_width, use_aug=use_aug, use_abi_aug=use_abi_aug,
                               use_color_aug=use_color_aug, rng=rng)
        self.root = root
        self.reader = LmdbReader(root)
        n = int(self.reader.get(b"num-samples"))
        if num_samples > 1:
            n = int(min(n, num_samples))
        elif num_samples > 0:
            n = int(n * num_samples)
        self.num_samples_total = n
        self.charset = build_charset(voc_type, max_len)
        self.img_height, self.img_width = img_height, img_width
        self.use_aug = use_aug
        # per-thread child streams: the loader fans single samples out to
        # worker threads, and numpy Generators are not thread-safe
        self.rng = rng
        if use_aug:
            if use_abi_aug:
                self.augment = ABIAugment(rng)
            else:
                self.augment = SeqCLRAugment(rng, color_only=use_color_aug)
        else:
            self.augment = None

    # expose the reference's vocab attributes for the metric layer
    @property
    def classes(self):
        return self.charset.classes

    @property
    def max_len(self):
        return self.charset.max_len

    def __len__(self):
        return self.num_samples_total

    def read_raw(self, index: int):
        """1-based LMDB record fetch -> (img_bytes, word) or None."""
        key_idx = index + 1
        img_buf = self.reader.get(b"image-%09d" % key_idx)
        label_buf = self.reader.get(b"label-%09d" % key_idx)
        if img_buf is None or label_buf is None:
            return None
        return img_buf, label_buf.decode("utf-8", errors="replace")

    def __getitem__(self, index: int):
        # skip unusable records by advancing (reference:
        # dataset/dataset_lmdb.py:173-187), bounded to avoid infinite loops
        for probe in range(64):
            rec = self.read_raw((index + probe) % len(self))
            if rec is None:
                continue
            img_buf, word = rec
            encoded = self.charset.encode(word)
            if encoded is None:
                continue
            img = decode_image(img_buf)
            if img is None:
                continue
            label, label_len = encoded
            if self.augment is not None:
                img = self.augment(img)
            img = resize_uint8(img, self.img_height, self.img_width)
            return img, label, np.int32(label_len)
        raise RuntimeError(f"no usable sample near index {index} in {self.root}")


class AloneImageLmdb(_ReopensInChild):
    """Unlabeled pre-training dataset: (original, augmented, masks)."""

    def __init__(
        self,
        root: str,
        max_len: int = 25,
        num_samples: float = np.inf,
        img_height: int = 32,
        img_width: int = 128,
        mask_ratio: float = 0.7,
        num_view: int = 2,
        window_size=(8, 32),
        use_aug: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        if not isinstance(rng, ThreadLocalRng):
            rng = ThreadLocalRng(rng if rng is not None else np.random.default_rng())
        self._init_args = dict(root=root, max_len=max_len, num_samples=num_samples,
                               img_height=img_height, img_width=img_width,
                               mask_ratio=mask_ratio, num_view=num_view,
                               window_size=window_size, use_aug=use_aug, rng=rng)
        self.root = root
        self.reader = LmdbReader(root)
        n = int(self.reader.get(b"num-samples"))
        if num_samples > 1:
            n = int(min(n, num_samples))
        elif num_samples > 0:
            n = int(n * num_samples)
        self.num_samples_total = n
        self.img_height, self.img_width = img_height, img_width
        self.rng = rng
        self.use_aug = use_aug
        self.num_view = num_view
        self.augment = SeqCLRAugment(rng) if use_aug else None
        self.mask_gen = RandomMaskingGenerator(window_size, mask_ratio,
                                               num_view=num_view, rng=rng)
        self.max_len = max_len
        self.charset = build_charset("ALLCASES_SYMBOLS", max_len)

    @property
    def classes(self):
        return self.charset.classes

    def __len__(self):
        return self.num_samples_total

    def __getitem__(self, index: int):
        for probe in range(64):
            img_buf = self.reader.get(b"image-%09d" % ((index + probe) % len(self) + 1))
            if img_buf is None:
                continue
            img = decode_image(img_buf)
            if img is None:
                continue
            mask = self.mask_gen()  # [num_view, N] (or [N] if num_view == 1)
            if mask.ndim == 1:
                mask = mask[None]
            ori = resize_uint8(img, self.img_height, self.img_width)
            if self.augment is not None:
                aug = resize_uint8(self.augment(img), self.img_height, self.img_width)
            else:
                aug = ori
            return ori, aug, mask.astype(bool)
        raise RuntimeError(f"no usable sample near index {index} in {self.root}")


class ConcatDataset:
    """Concatenation with bisect routing (reference:
    dataset/concatdatasets.py:10-56)."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cumulative_sizes = list(np.cumsum([len(d) for d in self.datasets]))
        self.charset = self.datasets[0].charset

    @property
    def classes(self):
        return self.charset.classes

    @property
    def max_len(self):
        return self.charset.max_len

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def source_of(self, idx: int) -> int:
        return bisect.bisect_right(self.cumulative_sizes, idx)

    def __getitem__(self, idx: int):
        d = self.source_of(idx)
        base = 0 if d == 0 else self.cumulative_sizes[d - 1]
        return self.datasets[d][idx - base]


def build_dataset(data_paths, is_train: bool, voc_type="ALLCASES_SYMBOLS",
                  max_len=25, num_samples=np.inf, use_aug=False, use_abi_aug=False,
                  img_height=32, img_width=128, rng=None):
    """Factory mirroring `build_dataset` (dataset/datasets.py:67-123)."""
    paths = data_paths if isinstance(data_paths, (list, tuple)) else [data_paths]
    # one shared thread-local wrapper across sub-datasets: per-dataset
    # wrappers around the SAME base generator would race on its
    # SeedSequence.spawn under the loader's per-sample thread fan-out
    if not isinstance(rng, ThreadLocalRng):
        rng = ThreadLocalRng(rng if rng is not None else np.random.default_rng())
    sets = [
        ImageLmdb(
            p, voc_type, max_len,
            num_samples if is_train else np.inf,
            img_height, img_width,
            use_aug=use_aug and is_train, use_abi_aug=use_abi_aug, rng=rng,
        )
        for p in paths
    ]
    return sets[0] if len(sets) == 1 else ConcatDataset(sets)


def build_pretraining_dataset(data_paths, mask_ratio=0.7, num_view=2,
                              num_samples=np.inf, max_len=25,
                              img_height=32, img_width=128, window_size=(8, 32),
                              rng=None):
    """Factory mirroring `build_pretraining_aloneimage_dataset`
    (dataset/datasets.py:52-64)."""
    paths = data_paths if isinstance(data_paths, (list, tuple)) else [data_paths]
    if not isinstance(rng, ThreadLocalRng):
        rng = ThreadLocalRng(rng if rng is not None else np.random.default_rng())
    sets = [
        AloneImageLmdb(
            p, max_len, num_samples, img_height, img_width,
            mask_ratio=mask_ratio, num_view=num_view, window_size=window_size,
            use_aug=num_view > 1, rng=rng,
        )
        for p in paths
    ]
    return sets[0] if len(sets) == 1 else ConcatDataset(sets)
