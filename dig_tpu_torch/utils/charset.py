"""Character vocabulary and label codec.

A copy of the parts of `dig_tpu.utils.charset` that inference, the eval
metrics and the labeled datasets use (the port imports nothing of the JAX
package).  Semantics follow the reference vocabulary
(dataset/dataset_lmdb.py:75-97, :185-204): three voc types, with EOS,
PADDING and UNKNOWN appended in that order; labels are fixed `max_len` int
arrays padded with PADDING, one EOS after the characters; a word with
``len(word) + 1 >= max_len`` is rejected; the decoders' BOS id is
``num_classes``.
"""

from __future__ import annotations

import dataclasses
import string

import numpy as np

_LOWERCASE_CHARS = "0123456789abcdefghijklmnopqrstuvwxyz!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"

EOS = "EOS"
PADDING = "PADDING"
UNKNOWN = "UNKNOWN"


@dataclasses.dataclass(frozen=True)
class Charset:
    voc_type: str
    classes: tuple
    max_len: int = 25

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def eos_id(self) -> int:
        return self.num_classes - 3

    @property
    def padding_id(self) -> int:
        return self.num_classes - 2

    @property
    def unknown_id(self) -> int:
        return self.num_classes - 1

    def encode(self, word: str):
        """One word -> (label [max_len] int32, label_len), or None when it
        is too long: usable only when ``len(word) + 1 < max_len``."""
        if self.voc_type == "LOWERCASE":
            word = word.lower()
        if len(word) + 1 >= self.max_len:
            return None
        label = np.full((self.max_len,), self.padding_id, dtype=np.int32)
        lut = {c: i for i, c in enumerate(self.classes)}
        ids = [lut.get(ch, self.unknown_id) for ch in word] + [self.eos_id]
        label[: len(ids)] = np.asarray(ids, dtype=np.int32)
        return label, len(ids)

    def decode(self, ids) -> str:
        """Ids to text: stop at the first EOS, drop UNKNOWN/PADDING and
        out-of-vocabulary ids (evaluation_metric/metrics.py:19-64)."""
        out = []
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            if i == self.eos_id:
                break
            if i in (self.unknown_id, self.padding_id) or i >= self.num_classes:
                continue
            out.append(self.classes[i])
        return "".join(out)


def normalize_text(text: str) -> str:
    """Case-insensitive alphanumeric normalization used by all string metrics
    (reference: evaluation_metric/metrics.py:14-16)."""
    alnum = string.digits + string.ascii_letters
    return "".join(ch for ch in text if ch in alnum).lower()


def build_charset(voc_type: str = "ALLCASES_SYMBOLS", max_len: int = 25) -> Charset:
    if voc_type == "LOWERCASE":
        voc = list(_LOWERCASE_CHARS)
    elif voc_type == "ALLCASES":
        voc = list(string.digits + string.ascii_letters)
    elif voc_type == "ALLCASES_SYMBOLS":
        voc = list(string.printable[:-6])
    else:
        raise KeyError(
            "voc_type must be one of 'LOWERCASE', 'ALLCASES', 'ALLCASES_SYMBOLS'"
        )
    voc += [EOS, PADDING, UNKNOWN]
    return Charset(voc_type=voc_type, classes=tuple(voc), max_len=max_len)
