"""The port's host data path against the JAX package's: augmentation,
masks, samplers, datasets, loader, per-step keys.

These modules are numpy + OpenCV in both packages, so nothing here is
"close": from the same seed and the same image both packages must give the
same bytes (on one machine: the pixels are OpenCV's), the same index
sequences and the same batches.  The LMDBs are written with the port's
`LmdbWriter` and read by each package's own reader.
"""

import os
import threading
import time

import cv2
import numpy as np
import pytest

from _torch_port_threads import one_thread
from dig_tpu.data import dataset as jds
from dig_tpu.data import folder as jfolder
from dig_tpu.data import masking as jmask
from dig_tpu.data import pipeline as jpipe
from dig_tpu.data import samplers as jsamp
from dig_tpu.data import transforms as jtf
from dig_tpu.utils import rng as jrng
from dig_tpu_torch.data import dataset as tds
from dig_tpu_torch.data import folder as tfolder
from dig_tpu_torch.data import masking as tmask
from dig_tpu_torch.data import pipeline as tpipe
from dig_tpu_torch.data import samplers as tsamp
from dig_tpu_torch.data import transforms as ttf
from dig_tpu_torch.data.lmdb_store import LmdbWriter
from dig_tpu_torch.utils import rng as trng


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module", autouse=True)
def _stop_process_workers():
    """The forkserver and the workers that the process-worker tests
    started, stopped when the module ends instead of with the worker."""
    yield
    tpipe.stop_worker_processes()


WORDS = ["hello", "World", "42abc", "x", "a-word-that-is-far-too-long-for-max-len", "Foo-Bar!",
         "qt", "zebra12", "corrupt", "last"]
CORRUPT = 9  # 1-based record whose image bytes are no image


def _image(seed, h=40, w=150):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _png(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def lmdb_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "words")
    rng = np.random.default_rng(0)
    with LmdbWriter(path) as w:
        for i, word in enumerate(WORDS, start=1):
            img = rng.integers(0, 256, (int(rng.integers(20, 60)), int(rng.integers(40, 200)), 3),
                               dtype=np.uint8)
            w.put(b"image-%09d" % i, b"no image at all" if i == CORRUPT else _png(img))
            w.put(b"label-%09d" % i, word.encode())
        w.put(b"num-samples", str(len(WORDS)).encode())
    return path


def _same_item(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

TRANSFORMS = ["random_rotate", "random_affine", "random_perspective", "gaussian_noise",
              "motion_blur", "pyramid_rescale", "color_jitter", "grayscale", "solarize",
              "linear_contrast", "gaussian_blur", "sharpen", "random_crop", "piecewise_affine"]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_bytes_equal(name):
    """One function, three seeds and image sizes: the same pixels, and the
    generator left in the same state (the same number of draws taken)."""
    for seed in range(3):
        img = _image(seed, 24 + 16 * seed, 90 + 60 * seed)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        want = getattr(jtf, name)(img.copy(), ra)
        got = getattr(ttf, name)(img.copy(), rb)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert ra.random() == rb.random()


def test_transform_helpers_equal():
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(8):
        assert jtf._rand_interp(ra) == ttf._rand_interp(rb)
        assert jtf.sample_asym(ra, 0.5) == ttf.sample_asym(rb, 0.5)
        assert jtf.sample_sym(ra, 0.5) == ttf.sample_sym(rb, 0.5)
        np.testing.assert_array_equal(jtf.sample_sym(ra, 2.0, size=4), ttf.sample_sym(rb, 2.0, size=4))
    np.testing.assert_array_equal(jtf._inverse_affine((10.0, 20.0), 12.0, 1.1, (3.0, -2.0)),
                                  ttf._inverse_affine((10.0, 20.0), 12.0, 1.1, (3.0, -2.0)))
    img = _image(1)
    np.testing.assert_array_equal(jtf.resize_uint8(img), ttf.resize_uint8(img))
    np.testing.assert_array_equal(jtf.resize_normalize(img), ttf.resize_normalize(img))


@pytest.mark.parametrize("augmenter,kwargs", [("SeqCLRAugment", {}),
                                              ("SeqCLRAugment", {"color_only": True}),
                                              ("ABIAugment", {})])
def test_composed_augmenters_bytes_equal(augmenter, kwargs):
    """40 images through one augmenter object each: every branch of the
    random composition is taken many times."""
    ja = getattr(jtf, augmenter)(np.random.default_rng(11), **kwargs)
    ta = getattr(ttf, augmenter)(np.random.default_rng(11), **kwargs)
    changed = 0
    for i in range(40):
        img = _image(100 + i, 24 + 8 * (i % 5), 60 + 20 * (i % 7))
        want, got = ja(img.copy()), ta(img.copy())
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        changed += got.shape != img.shape or not np.array_equal(got, img)
    assert changed >= 30  # the augmenters do augment


def test_transforms_import_without_cv2_and_name_it(monkeypatch):
    """cv2 is imported at first use: with OpenCV absent the module still
    imports and an augmentation that needs it says so."""
    import builtins
    import importlib
    import sys

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    monkeypatch.delitem(sys.modules, "cv2")
    fresh = importlib.reload(ttf)
    try:
        with pytest.raises(ImportError, match="cv2"):
            fresh.random_rotate(_image(0), np.random.default_rng(0))
    finally:
        monkeypatch.undo()
        importlib.reload(ttf)


# ---------------------------------------------------------------------------
# keys, masks, samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,stream,step", [(0, 0, 0), (1, 1, 7), (123456789, 0, 2**31 + 5),
                                              (2**32 + 3, 1, 2**32 + 9), (-1, 0, 1)])
def test_host_step_key_words_equal(seed, stream, step):
    want, got = jrng.host_step_key(seed, stream, step), trng.host_step_key(seed, stream, step)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, want)


def test_step_generator_is_a_function_of_seed_stream_step():
    import torch

    draw = lambda *a: torch.rand(4, generator=trng.step_generator(*a))
    assert torch.equal(draw(3, 1, 9), draw(3, 1, 9))
    for other in ((4, 1, 9), (3, 0, 9), (3, 1, 10)):
        assert not torch.equal(draw(3, 1, 9), draw(*other))
    hi, lo = (int(w) for w in trng.host_step_key(3, 1, 9))
    assert trng.step_generator(3, 1, 9).initial_seed() == (hi << 32) | (lo ^ hi)


@pytest.mark.parametrize("num_view", [1, 2])
def test_random_masking_generator_equal(num_view):
    jg = jmask.RandomMaskingGenerator((8, 32), 0.7, num_view, np.random.default_rng(2))
    tg = tmask.RandomMaskingGenerator((8, 32), 0.7, num_view, np.random.default_rng(2))
    assert repr(jg) == repr(tg)
    for _ in range(3):
        got = tg()
        np.testing.assert_array_equal(got, jg())
        assert got.reshape(num_view, -1).sum(-1).tolist() == [179] * num_view
    np.testing.assert_array_equal(tg.batch(5), jg.batch(5))


@pytest.mark.parametrize("n,world,shuffle,drop_last", [(10, 1, True, False), (10, 3, True, False),
                                                       (10, 3, False, False), (11, 4, True, True)])
def test_sharded_sampler_sequences_equal(n, world, shuffle, drop_last):
    seen = []
    for rank in range(world):
        js = jsamp.ShardedSampler(n, rank, world, shuffle=shuffle, seed=5, drop_last=drop_last)
        ts = tsamp.ShardedSampler(n, rank, world, shuffle=shuffle, seed=5, drop_last=drop_last)
        assert len(js) == len(ts) and js.num_samples == ts.num_samples
        for epoch in (0, 1, 4):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(js)
        seen += list(ts)
    if not drop_last:  # padded to a multiple of world: every index served
        assert set(seen) == set(range(n)) and len(seen) == -(-n // world) * world


@pytest.mark.parametrize("world", [1, 2])
def test_multi_source_batch_sampler_sequences_equal(world):
    sizes = [7, 19, 30]
    for rank in range(world):
        js = jsamp.MultiSourceBatchSampler(sizes, 4, rank, world, seed=2)
        ts = tsamp.MultiSourceBatchSampler(sizes, 4, rank, world, seed=2)
        assert len(js) == len(ts)
        for epoch in (0, 3):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            got = list(ts)
            assert got == list(js) and len(got) == len(ts)
            for batch in got:  # every batch from one source
                assert len({int(np.searchsorted(sizes, i, side="right")) for i in batch}) == 1


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def test_alone_image_lmdb_items_equal(lmdb_path):
    for num_view in (2, 1):
        jd = jds.build_pretraining_dataset(lmdb_path, num_view=num_view, rng=np.random.default_rng(4))
        td = tds.build_pretraining_dataset(lmdb_path, num_view=num_view, rng=np.random.default_rng(4))
        assert len(td) == len(jd) == len(WORDS)
        for i in list(range(len(td))) * 2:
            got = td[i]
            _same_item(got, jd[i])
            assert got[0].shape == (32, 128, 3) and got[0].dtype == np.uint8
            assert got[2].shape == (num_view, 256) and got[2].sum(-1).tolist() == [179] * num_view
        # the corrupt record is skipped by advancing to the next one
        _same_item(td[CORRUPT - 1][:1], tds.AloneImageLmdb(lmdb_path, use_aug=False)[CORRUPT][:1])


@pytest.mark.parametrize("aug", [dict(use_aug=False), dict(use_aug=True),
                                 dict(use_aug=True, use_abi_aug=True)])
def test_image_lmdb_items_equal(lmdb_path, aug):
    jd = jds.ImageLmdb(lmdb_path, max_len=25, rng=np.random.default_rng(6), **aug)
    td = tds.ImageLmdb(lmdb_path, max_len=25, rng=np.random.default_rng(6), **aug)
    assert len(td) == len(jd) and td.classes == jd.classes and td.max_len == jd.max_len
    for i in range(len(td)):
        _same_item(td[i], jd[i])
    # the too-long word (index 4) and the corrupt record (index 8) advance
    assert td.charset.decode(td[4][1]) == WORDS[5]
    assert td.charset.decode(td[CORRUPT - 1][1]) == WORDS[CORRUPT]


def test_concat_dataset_and_factories_equal(lmdb_path):
    jd = jds.build_dataset([lmdb_path, lmdb_path], True, use_aug=True, rng=np.random.default_rng(7),
                           num_samples=6)
    td = tds.build_dataset([lmdb_path, lmdb_path], True, use_aug=True, rng=np.random.default_rng(7),
                           num_samples=6)
    assert isinstance(td, tds.ConcatDataset) and len(td) == len(jd) == 12
    assert td.cumulative_sizes == jd.cumulative_sizes
    assert len({id(sub.rng) for sub in td.datasets}) == 1  # one ThreadLocalRng for all sources
    for i in (0, 5, 6, 11, 3):
        assert td.source_of(i) == jd.source_of(i)
        _same_item(td[i], jd[i])
    half = tds.ImageLmdb(lmdb_path, num_samples=0.5)
    assert len(half) == len(jds.ImageLmdb(lmdb_path, num_samples=0.5)) == 5


def test_image_folder_items_equal(tmp_path):
    for cls, n in (("cats", 3), ("dogs", 2)):
        os.makedirs(tmp_path / cls / "deep")
        for i in range(n):
            sub = "deep" if i == 2 else ""
            with open(tmp_path / cls / sub / f"{i}.png", "wb") as f:
                f.write(_png(_image(10 * n + i, 30 + i, 70 + 9 * i)))
    with open(tmp_path / "dogs" / "broken.png", "wb") as f:
        f.write(b"broken")
    aug_j = jtf.SeqCLRAugment(np.random.default_rng(1))
    aug_t = ttf.SeqCLRAugment(np.random.default_rng(1))
    jd = jfolder.ImageFolder(str(tmp_path), transform=aug_j, rng=np.random.default_rng(2))
    td = tfolder.ImageFolder(str(tmp_path), transform=aug_t, rng=np.random.default_rng(2))
    assert td.classes == jd.classes == ["cats", "dogs"] and td.samples == jd.samples
    assert len(td) == 6
    for i in range(len(td)):  # the broken file retries a random index, the same in both
        _same_item(td[i], jd[i])


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_wise_shuffle", [False, True])
def test_train_loader_batches_equal_over_two_epochs(lmdb_path, batch_wise_shuffle):
    """`make_train_loader` at one worker thread: the JAX loader's batches,
    byte for byte, host augmentation included."""
    paths = [lmdb_path, lmdb_path] if batch_wise_shuffle else lmdb_path
    jd = jds.build_pretraining_dataset(paths, rng=np.random.default_rng(0))
    td = tds.build_pretraining_dataset(paths, rng=np.random.default_rng(0))
    kw = dict(local_batch=4, rank=0, world=1, seed=3, num_workers=1,
              batch_wise_shuffle=batch_wise_shuffle)
    jl, tl = jpipe.make_train_loader(jd, **kw), tpipe.make_train_loader(td, **kw)
    assert len(tl) == len(jl) > 0
    firsts = []
    for epoch in (0, 1):
        jl.sampler.set_epoch(epoch)
        tl.sampler.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for g, w in zip(got, want):
            _same_item(g, w)
            assert g[0].shape == (4, 32, 128, 3) and g[2].shape == (4, 2, 256)
        firsts.append(got[0][0])
    assert not np.array_equal(*firsts)  # set_epoch reshuffles


def test_device_prefetch_keeps_order_and_depth():
    import torch

    made = []

    def to_device(item):
        made.append(item)
        return tpipe.pinned_to_device({"x": np.full((2,), item, np.uint8)}, "cpu")

    out = []
    for batch in tpipe.device_prefetch(iter(range(5)), to_device, depth=2):
        out.append(int(batch["x"][0]))
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].dtype == torch.uint8
        assert len(made) <= len(out) + 1  # one batch ahead of the consumer
    assert out == list(range(5))
    assert list(tpipe.device_prefetch(iter(range(3)), lambda i: i)) == \
        list(jpipe.device_prefetch(iter(range(3)), lambda i: i))


def test_stack_collates_like_jax():
    samples = [(np.full((2, 2), i, np.uint8), np.int32(i)) for i in range(3)]
    _same_item(tpipe._stack(samples), jpipe._stack(samples))
    dicts = [{"a": np.arange(3) + i} for i in range(2)]
    np.testing.assert_array_equal(tpipe._stack(dicts)["a"], jpipe._stack(dicts)["a"])


def test_abandoned_iterator_releases_producer(lmdb_path):
    ds = tds.ImageLmdb(lmdb_path, max_len=25)
    before = threading.active_count()
    loader = tpipe.DataLoader(ds, tsamp.ShardedSampler(len(ds), shuffle=False), batch_size=1,
                              num_workers=2, prefetch=2)
    for _ in loader:
        break  # abandon with batches still queued
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


class _Bad:
    """Module-level, so that process workers can receive it pickled."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        raise ValueError("boom")


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_worker_error_reaches_consumer(worker_type):
    loader = tpipe.DataLoader(_Bad(), tsamp.ShardedSampler(4, shuffle=False), batch_size=2,
                              num_workers=2, worker_type=worker_type)
    with pytest.raises(ValueError, match="boom"):
        list(loader)


class _StreamProbe:
    """Each item: (the first-ever draw of the serving worker's stream, its
    pid).  A worker's first item waits until the other worker has one too
    (a barrier sent along with the pickled dataset), so that both serve
    however late a worker starts."""

    def __init__(self, barrier=None):
        self.rng = tpipe.ThreadLocalRng(np.random.default_rng(0))
        self.barrier = barrier
        self._first = None

    def __len__(self):
        return 48

    def __getitem__(self, i):
        if self._first is None:
            if self.barrier is not None:
                self.barrier.wait(timeout=60)
            self._first = int(self.rng.integers(0, 2**62))
        time.sleep(0.01)
        return np.int64(self._first), np.int64(os.getpid())


def test_process_workers_get_distinct_streams_from_their_ordinals():
    """Process workers reseed from seed + ordinal (the JAX package: seed +
    PID), so two workers draw from two streams, and the same two on every
    run."""
    import multiprocessing as mp

    def run(seed):
        probe = _StreamProbe(mp.get_context("forkserver").Barrier(2))
        loader = tpipe.DataLoader(probe, tsamp.ShardedSampler(48, shuffle=False),
                                  batch_size=4, num_workers=2, worker_type="process", seed=seed)
        firsts, pids = (np.concatenate(x) for x in zip(*loader))
        assert len(set(pids.tolist())) == 2 and os.getpid() not in pids
        by_pid = {p: set(firsts[pids == p].tolist()) for p in set(pids.tolist())}
        assert all(len(v) == 1 for v in by_pid.values())  # one stream a worker
        return set(firsts.tolist())

    want = {int(tpipe.ThreadLocalRng(np.random.default_rng(7 + o)).integers(0, 2**62))
            for o in (0, 1)}
    assert len(want) == 2
    assert run(7) == want == run(7)
    assert run(8) != want


def test_process_workers_match_thread_workers(lmdb_path):
    ds = tds.ImageLmdb(lmdb_path, max_len=25)
    sampler = tsamp.ShardedSampler(len(ds), shuffle=False)
    want = list(tpipe.DataLoader(ds, sampler, batch_size=4, num_workers=2))
    got = list(tpipe.DataLoader(ds, sampler, batch_size=4, num_workers=2, worker_type="process"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same_item(g, w)


def test_spawn_child_without_generator_spawn():
    """On a numpy without `Generator.spawn` the child comes from the seed
    sequence: the same stream."""
    class Old:
        def __init__(self, g):
            self.bit_generator = g.bit_generator

    want = np.random.default_rng(3).spawn(1)[0].random(4)
    got = tpipe._spawn_child(Old(np.random.default_rng(3))).random(4)
    np.testing.assert_array_equal(got, want)
