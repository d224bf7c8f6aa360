"""The port's host-side image path against OpenCV and the JAX package:
`cubic_resize_uint8` (OpenCV's bicubic written out in numpy, what a machine
without cv2 runs) against `cv2.resize(INTER_CUBIC)`, `decode_image` against
`dig_tpu.data.dataset.decode_image`, and the predict CLI's file batches
with cv2 hidden against the JAX package's.

Tolerance of the resize, against OpenCV 5.0: every pixel within 1 grey
level, and at least `EQUAL_SHARE` of the pixels of an image equal.  Both
compute the same float32 filter; a pixel differs where a float32 sum lands
across a rounding tie (seen: at most 1 pixel of an image's 12,288)."""

import io
import sys

import cv2
import numpy as np
import pytest

from dig_tpu.data.dataset import decode_image as j_decode_image
from dig_tpu_torch.data.images import cubic_resize_uint8, decode_image, resize_uint8

EQUAL_SHARE = 0.9995  # of an image's pixels; the rest within 1 grey level
SHAPES = [(17, 61), (32, 100), (48, 300), (64, 512), (120, 40), (31, 127), (5, 5), (200, 800)]


def _image(kind, h, w, seed):
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    planes = [127 + 120 * np.sin(x / 7 + y / 5), 127 + 120 * np.cos(x / 11 - y / 3),
              x * 255.0 / w]
    return np.stack(planes, -1).clip(0, 255).astype(np.uint8)


def _assert_resize_close(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert diff.max() <= 1
    assert (diff == 0).mean() >= EQUAL_SHARE


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_cubic_resize_matches_opencv(kind, h, w):
    img = _image(kind, h, w, seed=h * 1000 + w)
    want = cv2.resize(img, (128, 32), interpolation=cv2.INTER_CUBIC)
    _assert_resize_close(cubic_resize_uint8(img, 32, 128), want)


@pytest.mark.parametrize("h,w,th,tw", [(32, 128, 64, 256), (40, 90, 48, 160), (64, 64, 7, 9)])
def test_cubic_resize_matches_opencv_at_other_targets(h, w, th, tw):
    img = _image("random", h, w, seed=7)
    want = cv2.resize(img, (tw, th), interpolation=cv2.INTER_CUBIC)
    _assert_resize_close(cubic_resize_uint8(img, th, tw), want)


def test_resize_leaves_an_image_of_the_target_size_untouched(monkeypatch):
    img = _image("random", 32, 128, seed=1)
    assert resize_uint8(img, 32, 128) is img
    np.testing.assert_array_equal(cubic_resize_uint8(img, 32, 128), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert resize_uint8(img, 32, 128) is img


def test_resize_uint8_uses_cv2_where_it_imports_and_numpy_where_not(monkeypatch):
    img = _image("smooth", 48, 300, seed=2)
    want = cv2.resize(img, (128, 32), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(resize_uint8(img, 32, 128), want)
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` now raises ImportError
    np.testing.assert_array_equal(resize_uint8(img, 32, 128), cubic_resize_uint8(img, 32, 128))
    _assert_resize_close(resize_uint8(img, 32, 128), want)


def test_cubic_resize_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        cubic_resize_uint8(np.zeros((4, 4, 3), np.float32), 2, 2)
    with pytest.raises(ValueError):
        cubic_resize_uint8(np.zeros((4, 4), np.uint8), 2, 2)


def _encoded(ext):
    img = _image("smooth", 24, 70, seed=3)
    ok, buf = cv2.imencode(ext, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("ext", [".png", ".jpg", ".bmp"])
def test_decode_image_matches_jax(ext):
    buf = _encoded(ext)
    got, want = decode_image(buf), j_decode_image(buf)
    assert got.dtype == np.uint8 and got.shape == (24, 70, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("buf", [b"", b"not an image at all", _encoded(".png")[:40]],
                         ids=["empty", "text", "truncated"])
def test_decode_image_gives_none_for_corrupt_bytes_as_jax(buf):
    assert decode_image(buf) is None and j_decode_image(buf) is None


def test_decode_image_without_cv2_uses_pil_and_agrees_on_png(monkeypatch):
    buf = _encoded(".png")  # lossless: both decoders give the same pixels
    want = decode_image(buf)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(decode_image(buf), want)
    assert decode_image(b"not an image at all") is None


def test_decode_image_raises_when_no_decoder_is_installed(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(RuntimeError, match="cv2.*PIL"):
        decode_image(_encoded(".png"))


def test_cli_file_batches_without_cv2_match_the_jax_package(tmp_path, monkeypatch):
    """The branch a machine without cv2 takes (PIL decode, numpy resize)
    against the JAX package's batches (cv2 decode and resize) on PNG files
    of several sizes: same names, pixels within the resize's tolerance."""
    from dig_tpu.cli.run_predict import iter_file_batches as j_iter
    from dig_tpu_torch.cli.run_predict import iter_file_batches

    paths = []
    for i, (h, w) in enumerate(SHAPES[:6] + [(32, 128)]):
        p = tmp_path / f"img{i}.png"
        img = _image("random" if i % 2 else "smooth", h, w, seed=20 + i)
        assert cv2.imwrite(str(p), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(str(p))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    paths.insert(3, str(tmp_path / "bad.png"))
    want = list(j_iter(paths, 4, 32, 128, 2))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = list(iter_file_batches(paths, 4, 32, 128, 2))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert sum(len(n) for n, _ in got) == 7
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape
        for x, y in zip(a, b):
            _assert_resize_close(x, y)


def test_no_pil_resize_remains_in_the_port():
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "dig_tpu_torch"
    hits = [str(p) for p in root.rglob("*.py")
            if ".resize(" in p.read_text().replace("cv2.resize(", "")]
    assert hits == []
