"""The port's data tools (`dig_tpu_torch.tools.{create_lmdb,gen_synth,gen_voc}`)
against the JAX package's (`tools/*.py`), on the CPU: from the same
inputs, arguments and seed, each pair writes byte-identical LMDB files
(``data.mdb``), the same word crops and the same vocabulary pickle.
create_lmdb runs with `--list`, `--images` and each `--dataset` parser on
tiny fixtures laid out as tests/test_lmdb_tools.py lays them out."""

import filecmp
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(path, w=40, h=24, seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    cv2.imwrite(path, rng.integers(0, 255, (h, w, 3)).astype(np.uint8))


def _both(tool, argv):
    """Run the JAX package's tool and the port's, each with the arguments
    `argv(side)` gives ("jax", "port"); fail on a non-zero exit."""
    for side in ("jax", "port"):
        cmd = ([sys.executable, os.path.join(ROOT, "tools", f"{tool}.py")] if side == "jax"
               else [sys.executable, "-m", f"dig_tpu_torch.tools.{tool}"])
        subprocess.run(cmd + [str(a) for a in argv(side)], cwd=ROOT, check=True,
                       capture_output=True, text=True, timeout=300)


def _same_tree(a, b):
    """Every file under a and b present in both, byte for byte."""
    names_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert names_a == names_b and names_a
    for name in names_a:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def _iam_fixture(tmp_path, pages=False):
    annot = tmp_path / "words.txt"
    annot.write_text(
        "# comment line\n"
        "a01-000u-00-00 ok 154 10 20 40 30 AT A\n"
        "a01-000u-00-01 ok 154 100 200 50 40 NN MOVE\n"
        "a01-000u-00-02 err 154 796 764 70 50 TO to\n"
        "b02-000-00-00 ok 154 10 10 20 20 NN other\n")
    split = tmp_path / "trainset.txt"
    split.write_text("a01-000u-00\n")
    if pages:
        _img(str(tmp_path / "images" / "a01-000u.png"), w=600, h=900)
    else:
        for i, name in enumerate(("a01-000u-00-00", "a01-000u-00-01")):
            _img(str(tmp_path / "words" / "a01" / "a01-000u" / f"{name}.png"), seed=i)
    return annot, split


@pytest.mark.parametrize("case", ["list", "images", "iam", "iam_fullimg", "cvl", "opentext"])
def test_create_lmdb_writes_the_same_bytes(case, tmp_path):
    words = tmp_path / "in"
    args = []
    if case in ("list", "images"):
        names = [f"w{i}.png" for i in range(5)]
        for i, n in enumerate(names):
            _img(str(words / n), w=30 + 7 * i, seed=i)
        (words / "bad.png").write_bytes(b"not an image")
        labels = ["hello", "world", "", "tpu", "dig"]
        if case == "list":
            lst = tmp_path / "labels.txt"
            lst.write_text("".join(f"{n}\t{w}\n" for n, w in zip(names, labels))
                           + "bad.png\tbad\nmissing.png\tgone\n")
            args = ["--list", lst, "--root", words]
        else:
            args = ["--root", words, "--images", *names, "bad.png", "--labels", *labels, "bad"]
    elif case == "iam":
        annot, split = _iam_fixture(tmp_path)
        args = ["--dataset", "iam", "--root", tmp_path / "words", "--annot", annot,
                "--split", split]
    elif case == "iam_fullimg":
        annot, split = _iam_fixture(tmp_path, pages=True)
        args = ["--dataset", "iam_fullimg", "--root", tmp_path / "images", "--annot", annot,
                "--split", split]
    elif case == "cvl":
        for i, name in enumerate(("0053/0053-1-0-0-Imagine.tif", "0053/0053-1-0-1-all.tif",
                                  "0071/0071-2-3-4-Grüße.tif")):
            _img(str(words / name), seed=i)
        args = ["--dataset", "cvl", "--root", words]
    else:
        for i, name in enumerate(("training_1_set/x.jpg", "training_1_set/skip.png",
                                  "validation_set/y.jpg")):
            _img(str(words / name), seed=i)
        args = ["--dataset", "opentext", "--root", words, "--subdirs", "training_1_set",
                "validation_set"]

    def argv(side):
        crops = ["--crop_dir", tmp_path / f"crops_{side}"] if case == "iam_fullimg" else []
        return [tmp_path / f"db_{side}", *args, *crops]

    _both("create_lmdb", argv)
    _same_tree(tmp_path / "db_jax", tmp_path / "db_port")
    if case == "iam_fullimg":
        _same_tree(tmp_path / "crops_jax", tmp_path / "crops_port")


def test_gen_synth_writes_the_same_bytes(tmp_path):
    flags = ["--train", "12", "--labeled", "6", "--test", "8", "--train_words", "20",
             "--test_words", "10", "--max_word_len", "6", "--seed", "3"]
    _both("gen_synth", lambda side: [tmp_path / side, *flags])
    _same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("case", ["lowercase", "no_lowercase"])
def test_gen_voc_writes_the_same_pickle(case, tmp_path):
    subprocess.run([sys.executable, "-m", "dig_tpu_torch.tools.gen_synth", str(tmp_path / "s"),
                    "--train", "30", "--labeled", "1", "--test", "1", "--train_words", "12",
                    "--test_words", "2", "--seed", "5"], cwd=ROOT, check=True,
                   capture_output=True, timeout=300)
    flags = [] if case == "lowercase" else ["--no-lowercase"]
    _both("gen_voc", lambda side: [tmp_path / "s" / "train", tmp_path / f"{side}.pkl", *flags])
    assert filecmp.cmp(tmp_path / "jax.pkl", tmp_path / "port.pkl", shallow=False)
