"""Two faults of the port, repaired, on the CPU.

* `to_model_images` maps uint8 through a 256-entry table built on the host
  with the JAX package's arithmetic: every value bit-equal to
  `dig_tpu.ops.images.to_model_images` (on the card the division would be a
  product with the reciprocal, one ulp off for some values).
* Process workers start from a forkserver and receive the dataset pickled;
  an iterator abandoned half-way returns at once and the next one gives the
  thread workers' bytes.
"""

import os
import pickle
import threading
import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops.images import to_model_images as j_to_model_images
from dig_tpu_torch.data import dataset as tds
from dig_tpu_torch.data import pipeline as tpipe
from dig_tpu_torch.data import samplers as tsamp
from dig_tpu_torch.data.lmdb_store import LmdbWriter
from dig_tpu_torch.ops.images import to_model_images, uint8_table

N = 48


def test_uint8_table_is_bit_equal_to_jax():
    x = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1)
    want = np.asarray(j_to_model_images(jnp.asarray(x)))
    got = to_model_images(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert uint8_table("cpu") is uint8_table("cpu")  # built once a device
    assert float(got.min()) == -1.0 and float(got.max()) == 1.0


def test_float_images_pass_through():
    x = torch.rand(2, 32, 128, 3) * 2 - 1
    assert to_model_images(x) is x


@pytest.fixture(scope="module")
def lmdb_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("repairs") / "words")
    rng = np.random.default_rng(0)
    with LmdbWriter(path) as w:
        for i in range(1, N + 1):
            img = rng.integers(0, 256, (32, 48 + 8 * (i % 7), 3), dtype=np.uint8)
            ok, buf = cv2.imencode(".png", img)
            assert ok
            w.put(b"image-%09d" % i, buf.tobytes())
            w.put(b"label-%09d" % i, f"w{i}".encode())
        w.put(b"num-samples", str(N).encode())
    return path


def test_datasets_pickle_as_their_arguments_and_reopen(lmdb_path):
    ds = tds.build_dataset([lmdb_path, lmdb_path], is_train=True, use_aug=True,
                           rng=np.random.default_rng(1))
    copy = pickle.loads(pickle.dumps(ds))
    assert len(copy) == len(ds) == 2 * N
    a, b = copy.datasets
    assert a.rng is b.rng  # one stream wrapper shared by both, as in the original
    assert a.reader is not ds.datasets[0].reader  # a reader of its own
    ori = tds.AloneImageLmdb(lmdb_path, num_view=1, rng=np.random.default_rng(2))
    again = pickle.loads(pickle.dumps(ori))
    for i in (0, 7):
        for x, y in zip(ori[i], again[i]):
            np.testing.assert_array_equal(x, y)


def test_a_dataset_that_does_not_pickle_fails_at_once_with_process_workers():
    """The pickling error of the pool's start reaches the consumer; nothing hangs."""
    class Local:  # a local class does not pickle
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return np.zeros(1)

    loader = tpipe.DataLoader(Local(), tsamp.ShardedSampler(2, shuffle=False), batch_size=1,
                              worker_type="process")
    t0 = time.monotonic()
    with pytest.raises((AttributeError, pickle.PicklingError, TypeError), match="local"):
        list(loader)
    assert time.monotonic() - t0 < 30.0


def test_abandoned_process_iterator_returns_and_the_next_gives_the_thread_bytes(lmdb_path):
    """Break out after 2 of 12 batches with work in flight: the abandoned
    iterator's pool is shut down without waiting on it, and a new process
    iterator gives the thread workers' batches byte for byte, within 30 s
    in all."""
    ds = tds.ImageLmdb(lmdb_path, max_len=25)
    sampler = tsamp.ShardedSampler(len(ds), shuffle=False)
    want = list(tpipe.DataLoader(ds, sampler, batch_size=4, num_workers=2))
    loader = tpipe.DataLoader(ds, sampler, batch_size=4, num_workers=2, worker_type="process")
    before = threading.active_count()
    t0 = time.monotonic()
    for i, _ in enumerate(loader):
        if i == 1:
            break
    got = list(loader)
    assert time.monotonic() - t0 < 30.0
    assert len(got) == len(want) == N // 4
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    deadline = time.monotonic() + 10.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "a producer or pool thread leaked"


def _multiprocessing_children() -> list:
    """cmdlines of this process's live children that multiprocessing started."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z" and "multiprocessing" in cmd:
            found.append(cmd)
    return found


def test_stop_worker_processes_leaves_no_server_behind(lmdb_path):
    """After an abandoned and a finished process iterator, the forkserver and
    the resource tracker are this process's children; `stop_worker_processes`
    ends them (and the workers) so that a program can exit leaving nothing
    running, and a later loader starts a new server."""
    ds = tds.ImageLmdb(lmdb_path, max_len=25)
    loader = tpipe.DataLoader(ds, tsamp.ShardedSampler(len(ds), shuffle=False), batch_size=4,
                              num_workers=2, worker_type="process")
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert len(list(loader)) == N // 4
    assert any("forkserver" in c for c in _multiprocessing_children())
    assert tpipe.stop_worker_processes() == []
    assert _multiprocessing_children() == []
    assert len(list(loader)) == N // 4
    tpipe.stop_worker_processes()
    assert _multiprocessing_children() == []
