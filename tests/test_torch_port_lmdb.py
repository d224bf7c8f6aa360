"""The port's LMDB store and the predict CLI's `--data_path` input against
the JAX package: files written by either `LmdbWriter` are read by the
other's `LmdbReader` on every backend that is available here,
`iter_lmdb_batches` gives the JAX package's names and pixels, and the CLI
writes the same TSV for image files plus an LMDB with a corrupt record."""

import os
import pathlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dig_tpu.data.lmdb_store as jstore
import dig_tpu_torch.data.lmdb_store as tstore
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu_torch.models.rec_model import build_rec_model as t_build_rec_model
from dig_tpu_torch.ops import activations as tact
from dig_tpu_torch.utils.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = ["native", "python"]  # the `lmdb` package is not installed here


@pytest.fixture(autouse=True)
def _one_thread_and_gelu():
    n, exact = torch.get_num_threads(), tact.EXACT
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tact.set_exact(exact)


def _items(seed, n=300):
    """Small values, values that overflow a page (over ~2 KB), an empty
    value and enough keys for a branch level."""
    rng = np.random.default_rng(seed)
    items = {b"num-samples": str(n).encode(), b"empty": b""}
    for i in range(1, n + 1):
        size = int(rng.integers(1, 60)) if i % 9 else int(rng.integers(2100, 30000))
        items[b"image-%09d" % i] = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        items[b"label-%09d" % i] = b"w%d" % i
    return items


def _write(store, path, items):
    with store.LmdbWriter(str(path)) as w:
        for k, v in items.items():
            w.put(k, v)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_lmdb_files_round_trip_between_the_packages(tmp_path, writer, reader, backend):
    stores = {"port": tstore, "jax": jstore}
    items = _items(seed=1)
    _write(stores[writer], tmp_path / "db", items)
    r = stores[reader].LmdbReader(str(tmp_path / "db"), backend=backend)
    try:
        assert r.backend == backend and r.entries == len(items)
        for k, v in items.items():
            assert r.get(k) == v
        assert r.get(b"image-%09d" % 0) is None and r.get(b"zzz") is None
    finally:
        r.close()


def test_both_writers_give_the_same_bytes(tmp_path):
    items = _items(seed=2, n=120)
    _write(tstore, tmp_path / "a", items)
    _write(jstore, tmp_path / "b", items)
    assert (tmp_path / "a" / "data.mdb").read_bytes() == (tmp_path / "b" / "data.mdb").read_bytes()


def test_native_reader_is_built_from_the_ports_source_into_an_ignored_directory():
    assert tstore.native_lib() is not None  # g++ is installed here
    build = ROOT / "dig_tpu_torch" / "data" / "native" / "_build"
    libs = list(build.glob("libdig_lmdb-*.so"))
    assert libs and (ROOT / "dig_tpu_torch" / "data" / "native" / "dig_lmdb.cpp").exists()
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "dig_tpu_torch/data/native/_build/" in ignored
    # no binary lies anywhere else under the port's data package
    assert all(p.parent == build for p in (ROOT / "dig_tpu_torch" / "data").rglob("*.so"))


def test_missing_lmdb_raises(tmp_path):
    with pytest.raises((OSError, FileNotFoundError)):
        tstore.LmdbReader(str(tmp_path / "nothing"))


def _image_lmdb(store, path, corrupt=(2,), n=5, seed=5):
    """An unlabeled LMDB of JPEG records of several sizes; the records in
    `corrupt` hold bytes that are no image, record n - 1 is missing."""
    rng = np.random.default_rng(seed)
    with store.LmdbWriter(str(path)) as w:
        for i in range(1, n + 1):
            if i in corrupt:
                w.put(b"image-%09d" % i, b"corrupt bytes")
            elif i != n - 1:
                img = rng.integers(0, 255, size=(20 + 6 * i, 70 + 30 * i, 3), dtype=np.uint8)
                ok, buf = cv2.imencode(".jpg", img)
                assert ok
                w.put(b"image-%09d" % i, buf.tobytes())
        w.put(b"num-samples", str(n).encode())


def test_iter_lmdb_batches_matches_jax(tmp_path, capsys):
    from dig_tpu.cli.run_predict import iter_lmdb_batches as j_iter
    from dig_tpu.config import PredictConfig as JPredictConfig
    from dig_tpu_torch.cli.run_predict import iter_lmdb_batches
    from dig_tpu_torch.config import PredictConfig

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _image_lmdb(tstore, a, corrupt=(2,), n=5)
    _image_lmdb(jstore, b, corrupt=(1, 6), n=7, seed=6)
    want = list(j_iter([a, b], 2, JPredictConfig(input_h=32, input_w=128), 2))
    capsys.readouterr()
    got = list(iter_lmdb_batches([a, b], 2, PredictConfig(input_h=32, input_w=128), 2))
    err = capsys.readouterr().err
    names = [n for ns, _ in got for n in ns]
    # a corrupt or missing record is skipped under its own name, never
    # replaced by a neighbour; batches do not run across two LMDBs
    assert names == [f"{a}#1", f"{a}#3", f"{a}#5", f"{b}#2", f"{b}#3", f"{b}#4", f"{b}#5",
                     f"{b}#7"]
    assert [ns for ns, _ in got] == [ns for ns, _ in want]
    for (_, x), (_, y) in zip(got, want):
        assert x.dtype == np.uint8 and x.shape[1:] == (32, 128, 3)
        np.testing.assert_array_equal(x, y)
    for skipped in (f"{a}#2", f"{a}#4", f"{b}#1", f"{b}#6"):
        assert f"skipping unreadable record {skipped!r}" in err
    assert "native LMDB backend" in err  # the backend is named once per LMDB


def test_iter_lmdb_batches_refuses_an_lmdb_without_num_samples(tmp_path):
    from dig_tpu_torch.cli.run_predict import iter_lmdb_batches
    from dig_tpu_torch.config import PredictConfig

    with tstore.LmdbWriter(str(tmp_path / "db")) as w:
        w.put(b"image-%09d" % 1, b"x")
    with pytest.raises(ValueError, match="num-samples"):
        list(iter_lmdb_batches([str(tmp_path / "db")], 2, PredictConfig()))


def test_cli_main_on_files_and_an_lmdb_writes_the_same_tsv_as_jax(tmp_path):
    """3 PNG files and an LMDB of 5 records (one corrupt, one missing)
    through both CLIs at vit_micro + small_tf_decoder in fp32, the weights
    carried across by `params_from_jax`: the same lines in the same order
    (files first), ids equal, confidences within 1e-4."""
    from dig_tpu.cli.run_predict import main as j_main
    from dig_tpu.config import PredictConfig as JPredictConfig
    from dig_tpu_torch.cli.run_predict import main as t_main
    from dig_tpu_torch.config import PredictConfig

    jm = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                     jnp.zeros((2, 25), jnp.int32), jnp.ones((2,), jnp.int32), True)["params"]
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p)).astype(np.float32), params)
    tm = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    tm.load_state_dict(params_from_jax(params))
    pth = tmp_path / "rec.pth"
    torch.save({"model": tm.state_dict()}, pth)

    (tmp_path / "imgs").mkdir()
    for i in range(3):
        img = rng.integers(0, 256, (32, 60 + 10 * i, 3), dtype=np.uint8)
        assert cv2.imwrite(str(tmp_path / "imgs" / f"img{i}.png"), img)
    db = str(tmp_path / "db")
    _image_lmdb(tstore, db, corrupt=(2,), n=5)

    common = dict(model="vit_micro_patch4_32x128", decoder_name="small_tf_decoder",
                  batch_size=4, dtype="float32", images=[str(tmp_path / "imgs")],
                  data_path=[db], finetune=str(pth), exact_gelu=False, num_workers=2)
    assert j_main(JPredictConfig(output=str(tmp_path / "jax.tsv"), **common)) == 6
    assert t_main(PredictConfig(output=str(tmp_path / "port.tsv"), **common), device="cpu") == 6
    jl = (tmp_path / "jax.tsv").read_text().splitlines()
    tl = (tmp_path / "port.tsv").read_text().splitlines()
    assert len(jl) == len(tl) == 6
    assert [line.split("\t")[0] for line in tl] == \
        [os.path.join(str(tmp_path / "imgs"), f"img{i}.png") for i in range(3)] + \
        [f"{db}#{i}" for i in (1, 3, 5)]
    for a, b in zip(jl, tl):
        (na, ta, ca), (nb, tb, cb) = a.split("\t"), b.split("\t")
        assert (na, ta) == (nb, tb)
        assert abs(float(ca) - float(cb)) <= 1e-4
        assert 0.0 < float(cb) <= 1.0
