"""Generate synthetic scene-text-style word LMDBs for validation runs.

The port's copy of `tools/gen_synth.py`, on `dig_tpu_torch`'s LMDB writer:
the same arguments, the same bytes for the same seed, no JAX.

No real STR data (MJSynth/SynthText, IIIT5k, ...) is reachable from a
zero-egress box, so this renders a MJSynth-like corpus with cv2: random
fonts/scales/colors over noise backgrounds, perspective warps, blur and
JPEG re-encoding.  Fills the role of the reference's unlabeled corpus
(README.md:53-79: ~16M images) at whatever scale the box allows.

Writes straight into the reference LMDB schema (image-%09d / label-%09d /
num-samples) through the framework's native writer — no temp image files.

Usage:
    python -m dig_tpu_torch.tools.gen_synth OUT_DIR --train 60000 --labeled 1500 \
        --test 5000 [--seed 0]

Produces OUT_DIR/{train,labeled,test} LMDBs.  `labeled` is drawn from the
same word pool as `train`; `test` uses a disjoint word pool so accuracy
measures character recognition, not word memorization.
"""

from __future__ import annotations

import argparse
import os
import string

import cv2
import numpy as np

from dig_tpu_torch.data.lmdb_store import LmdbWriter

FONTS = [
    cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_PLAIN, cv2.FONT_HERSHEY_DUPLEX,
    cv2.FONT_HERSHEY_COMPLEX, cv2.FONT_HERSHEY_TRIPLEX,
    cv2.FONT_HERSHEY_COMPLEX_SMALL, cv2.FONT_HERSHEY_SCRIPT_SIMPLEX,
    cv2.FONT_HERSHEY_SCRIPT_COMPLEX,
]
EASY_FONTS = FONTS[:6]  # drop the cursive script faces
CHARS = string.digits + string.ascii_lowercase


def make_word_pool(rng: np.random.Generator, n_words: int, max_len: int = 10):
    """Random words, MJSynth-like length distribution (2-max_len chars)."""
    pool = set()
    while len(pool) < n_words:
        length = int(np.clip(rng.poisson(4.5) + 2, 2, max_len))
        pool.add("".join(rng.choice(list(CHARS), size=length)))
    return sorted(pool)


def render_word(rng: np.random.Generator, word: str, easy: bool = False) -> bytes:
    """`easy` drops the cursive fonts and the full-noise backgrounds —
    a regime small supervised budgets can learn from (used by the SSL
    validation runs; the default regime matches scene-text difficulty)."""
    fonts = EASY_FONTS if easy else FONTS
    font = fonts[rng.integers(len(fonts))]
    scale = float(rng.uniform(0.7, 1.6))
    thickness = int(rng.integers(1, 3))
    (tw, th), baseline = cv2.getTextSize(word, font, scale, thickness)
    pad_x = int(rng.integers(4, 16))
    pad_y = int(rng.integers(4, 14))
    w, h = tw + 2 * pad_x, th + baseline + 2 * pad_y

    # background: noise / flat / vertical gradient
    bg_kind = rng.integers(2 if easy else 3)
    base = rng.integers(0, 256, 3)
    if bg_kind == 0 and not easy:
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    elif bg_kind == 0 or bg_kind == 1:
        img = np.full((h, w, 3), base, np.uint8)
    else:
        g = np.linspace(0, rng.integers(40, 120), h)[:, None, None]
        img = np.clip(base[None, None, :] + g, 0, 255).astype(np.uint8)

    # foreground color with guaranteed contrast to the background mean
    bg_mean = img.mean()
    if bg_mean > 127:
        fg = tuple(int(v) for v in rng.integers(0, 90, 3))
    else:
        fg = tuple(int(v) for v in rng.integers(165, 255, 3))
    cv2.putText(img, word, (pad_x, th + pad_y), font, scale, fg, thickness,
                cv2.LINE_AA)

    # perspective jitter
    if rng.random() < 0.5:
        j = 0.08 * min(w, h)
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = src + rng.uniform(-j, j, (4, 2)).astype(np.float32)
        img = cv2.warpPerspective(img, cv2.getPerspectiveTransform(src, dst),
                                  (w, h), borderMode=cv2.BORDER_REPLICATE)
    if rng.random() < 0.3:
        k = 2 * int(rng.integers(1, 3)) + 1
        img = cv2.GaussianBlur(img, (k, k), 0)

    q = int(rng.integers(55, 96))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
    assert ok
    return buf.tobytes()


def write_split(path: str, rng: np.random.Generator, words, n: int,
                easy: bool = False):
    with LmdbWriter(path) as w:
        for i in range(1, n + 1):
            word = words[rng.integers(len(words))]
            w.put(b"image-%09d" % i, render_word(rng, word, easy=easy))
            w.put(b"label-%09d" % i, word.encode())
            if i % 5000 == 0:
                print(f"  {path}: {i}/{n}", flush=True)
        w.put(b"num-samples", str(n).encode())
    print(f"wrote {n} samples -> {path}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--train", type=int, default=60000)
    ap.add_argument("--labeled", type=int, default=1500)
    ap.add_argument("--test", type=int, default=5000)
    ap.add_argument("--train_words", type=int, default=8000)
    ap.add_argument("--test_words", type=int, default=2000)
    ap.add_argument("--max_word_len", type=int, default=10)
    ap.add_argument("--easy", action="store_true",
                    help="no cursive fonts / noise backgrounds")
    ap.add_argument("--test_pool", choices=["disjoint", "shared"],
                    default="disjoint",
                    help="'disjoint': test words never seen in training "
                         "(measures pure char recognition); 'shared': test "
                         "words drawn from the training vocabulary on fresh "
                         "renders — the regime of the real STR benchmarks, "
                         "whose lexicons overlap the training corpora")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    pool = make_word_pool(rng, args.train_words + args.test_words,
                          max_len=args.max_word_len)
    perm = rng.permutation(len(pool))
    train_words = [pool[i] for i in perm[: args.train_words]]
    if args.test_pool == "shared":
        test_words = train_words
    else:
        test_words = [pool[i] for i in perm[args.train_words:]]

    os.makedirs(args.out_dir, exist_ok=True)
    write_split(os.path.join(args.out_dir, "train"), rng, train_words,
                args.train, easy=args.easy)
    write_split(os.path.join(args.out_dir, "labeled"), rng, train_words,
                args.labeled, easy=args.easy)
    write_split(os.path.join(args.out_dir, "test"), rng, test_words,
                args.test, easy=args.easy)


if __name__ == "__main__":
    main()
