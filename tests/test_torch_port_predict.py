"""The predict slice of the PyTorch port end to end against the JAX package:
`RecModel.recognize`, the predict function (ids + confidences), the CLI
on image files, the config and charset copies, and the rule that the port
imports nothing of JAX or of `dig_tpu`."""

import ast
import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_threads import one_thread
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu_torch.models.rec_model import build_rec_model as t_build_rec_model
from dig_tpu_torch.ops import activations as tact
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.utils.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(autouse=True)
def _gelu():
    exact = tact.EXACT
    yield
    tact.set_exact(exact)


@pytest.fixture(scope="module")
def micro_pair():
    """JAX micro recognizer with perturbed weights and the port carrying
    the same weights."""
    jm = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                     jnp.zeros((2, 25), jnp.int32), jnp.ones((2,), jnp.int32), True)["params"]
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p)).astype(np.float32), params)
    tm = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    tm.load_state_dict(params_from_jax(params))
    images = np.random.default_rng(11).integers(0, 256, (4, 32, 128, 3), dtype=np.uint8)
    return jm, params, tm, images


def test_recognize_matches_jax(micro_pair):
    jm, params, tm, images = micro_pair
    jp, jids = jm.apply({"params": params}, to_model_images_jax(images), 0, 94,
                        method=jm.recognize)
    tp, tids = tm.recognize(to_model_images(torch.from_numpy(images)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    # fp32 micro encoder + 2-layer decoder, 25 steps: ~1e-6 on probabilities
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)


def to_model_images_jax(images):
    from dig_tpu.ops.images import to_model_images as j_to_model_images

    return j_to_model_images(jnp.asarray(images))


def test_predict_fn_matches_jax(micro_pair):
    from dig_tpu.cli.run_predict import make_predict_fn as j_make_predict_fn
    from dig_tpu.config import PredictConfig as JPredictConfig
    from dig_tpu_torch.cli.run_predict import make_predict_fn

    jm, params, tm, images = micro_pair
    jids, jconf = j_make_predict_fn(jm, JPredictConfig(), eos=94)(params, jnp.asarray(images))
    tids, tconf = make_predict_fn(tm, 94)(torch.from_numpy(images))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    # geometric mean of fp32 probabilities: relative error ~1e-6
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), rtol=1e-5)


@pytest.mark.parametrize("k", [2, 3])
def test_predict_fn_beam_matches_jax(micro_pair, k):
    """Beam ids, and their confidences from the teacher-forced rescoring."""
    from dig_tpu.cli.run_predict import make_predict_fn as j_make_predict_fn
    from dig_tpu.config import PredictConfig as JPredictConfig
    from dig_tpu_torch.cli.run_predict import make_predict_fn

    jm, params, tm, images = micro_pair
    jids, jconf = j_make_predict_fn(jm, JPredictConfig(beam_width=k), eos=94)(
        params, jnp.asarray(images))
    tids, tconf = make_predict_fn(tm, 94, beam_width=k)(torch.from_numpy(images))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), rtol=1e-5)
    assert ((tconf > 0) & (tconf <= 1)).all()


def _write_pngs(d, n):
    import cv2

    rng = np.random.default_rng(12)
    d.mkdir()
    for i in range(n):
        img = rng.integers(0, 256, (32, 60 + 10 * i, 3), dtype=np.uint8)
        assert cv2.imwrite(str(d / f"img{i}.png"), img)


def test_cli_main_writes_same_tsv_as_jax(tmp_path, micro_pair):
    """8 PNG files through both CLIs, with the port's weights saved as a
    reference-layout .pth (`--finetune`): same names and texts, and
    confidences equal to their 4 printed decimals (one unit of slack for
    rounding at a boundary)."""
    from dig_tpu.cli.run_predict import main as j_main
    from dig_tpu.config import PredictConfig as JPredictConfig
    from dig_tpu_torch.cli.run_predict import main as t_main
    from dig_tpu_torch.config import PredictConfig

    _, _, tm, _ = micro_pair
    _write_pngs(tmp_path / "imgs", 8)
    pth = tmp_path / "rec.pth"
    torch.save({"model": tm.state_dict()}, pth)
    common = dict(model="vit_micro_patch4_32x128", decoder_name="small_tf_decoder",
                  batch_size=5, dtype="float32", images=[str(tmp_path / "imgs")],
                  finetune=str(pth), exact_gelu=False, num_workers=2)
    assert j_main(JPredictConfig(output=str(tmp_path / "jax.tsv"), **common)) == 8
    assert t_main(PredictConfig(output=str(tmp_path / "port.tsv"), **common), device="cpu") == 8
    jl = (tmp_path / "jax.tsv").read_text().splitlines()
    tl = (tmp_path / "port.tsv").read_text().splitlines()
    assert len(jl) == len(tl) == 8
    for a, b in zip(jl, tl):
        (na, ta, ca), (nb, tb, cb) = a.split("\t"), b.split("\t")
        assert (na, ta) == (nb, tb)
        assert abs(float(ca) - float(cb)) <= 1e-4
        assert 0.0 < float(cb) <= 1.0


def test_cli_auto_erf_for_pth(tmp_path, micro_pair):
    from dig_tpu_torch.cli.run_predict import main
    from dig_tpu_torch.config import PredictConfig

    _, _, tm, _ = micro_pair
    _write_pngs(tmp_path / "imgs", 2)
    torch.save(tm.state_dict(), tmp_path / "w.pth")
    tact.set_exact(False)
    cfg = PredictConfig(model="vit_micro_patch4_32x128", decoder_name="small_tf_decoder",
                        batch_size=2, dtype="float32", images=[str(tmp_path / "imgs")],
                        finetune=str(tmp_path / "w.pth"), output=str(tmp_path / "o.tsv"))
    assert main(cfg, device="cpu") == 2
    assert tact.EXACT  # weights from a .pth are evaluated under erf-GELU


@pytest.mark.parametrize("field,value,exc,words", [
    # --resume reads a native or a port directory (test_torch_port_remote_native.py);
    # one that does not exist is refused
    ("resume", "out/checkpoint-best", FileNotFoundError, "checkpoint-best"),
    ("model_kind", "ctc_beam", ValueError, "unknown model_kind"),
    ("decoder_name", "rnn_decoder", KeyError, "unknown decoder"),
    ("use_feat_distill", True, ValueError, "requires model_kind 'rec'"),
])
def test_cli_refuses_unported_options(field, value, exc, words):
    """Every model kind, decoder and `--text_cond_vis` serves
    (test_torch_port_kinds_aux_cli.py); what is refused is a checkpoint
    directory that does not exist, a kind or decoder `dig_tpu` does not
    have, and a distillation projector on a kind that has none."""
    from dig_tpu_torch.cli.run_predict import main
    from dig_tpu_torch.config import PredictConfig

    cfg = PredictConfig(images=["x.png"], model="vit_micro_patch4_32x128")
    if field == "use_feat_distill":
        cfg.model_kind = "attn"
    setattr(cfg, field, value)
    with pytest.raises(exc, match=words):
        main(cfg, device="cpu")


def test_cli_needs_input():
    from dig_tpu_torch.cli.run_predict import main
    from dig_tpu_torch.config import PredictConfig

    with pytest.raises(SystemExit):
        main(PredictConfig(), device="cpu")


def test_image_paths_and_batches_match_jax(tmp_path):
    from dig_tpu.cli.run_predict import collect_image_paths as j_collect
    from dig_tpu.cli.run_predict import iter_file_batches as j_iter
    from dig_tpu_torch.cli.run_predict import collect_image_paths, iter_file_batches

    _write_pngs(tmp_path / "imgs", 5)
    (tmp_path / "imgs" / "bad.png").write_bytes(b"not an image")
    (tmp_path / "imgs" / "notes.txt").write_text("x")
    specs = [str(tmp_path / "imgs"), str(tmp_path / "imgs" / "*.png")]
    paths = collect_image_paths(specs)
    assert paths == j_collect(specs)
    got = list(iter_file_batches(paths, 2, 32, 128, 2))
    want = list(j_iter(paths, 2, 32, 128, 2))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)  # same cv2 decode + bicubic resize


def test_predict_config_matches_jax():
    from dig_tpu.config import PredictConfig as J
    from dig_tpu.config import parse_config as j_parse
    from dig_tpu_torch.config import PredictConfig as T
    from dig_tpu_torch.config import parse_config as t_parse

    assert [(f.name, f.default if f.default is not dataclasses.MISSING else None)
            for f in dataclasses.fields(T)] == \
           [(f.name, f.default if f.default is not dataclasses.MISSING else None)
            for f in dataclasses.fields(J)]
    argv = ["--model", "vit_micro_patch4_32x128", "--batch_size", "8", "--images", "a", "b",
            "--no_use_mean_pooling", "--exact_gelu", "true", "--dtype", "float32",
            "--bogus_flag", "1"]
    assert dataclasses.asdict(t_parse(T, argv)) == dataclasses.asdict(j_parse(J, argv))


@pytest.mark.parametrize("voc", ["LOWERCASE", "ALLCASES", "ALLCASES_SYMBOLS"])
def test_charset_matches_jax(voc):
    from dig_tpu.utils.charset import build_charset as j_build
    from dig_tpu_torch.utils.charset import build_charset as t_build

    j, t = j_build(voc), t_build(voc)
    assert t.classes == j.classes and t.eos_id == j.eos_id
    ids = np.random.default_rng(13).integers(0, t.num_classes + 1, (20, 25))
    assert [t.decode(r) for r in ids] == [j.decode(r) for r in ids]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_dig_tpu():
    files = (sorted((ROOT / "dig_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + [ROOT / "bench_torch.py"] + sorted((ROOT / "tools").glob("time_*.py")))
    assert len(files) > 15
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"dig_tpu_torch/data/images.py", "dig_tpu_torch/data/lmdb_store.py",
            "dig_tpu_torch/data/pipeline.py", "dig_tpu_torch/data/device_aug.py",
            "dig_tpu_torch/utils/checkpoint.py", "dig_tpu_torch/utils/logging.py",
            "dig_tpu_torch/utils/metric_logger.py", "dig_tpu_torch/cli/run_pretrain.py",
            "dig_tpu_torch/cli/run_finetune.py", "dig_tpu_torch/utils/preemption.py",
            "dig_tpu_torch/utils/profiling.py", "dig_tpu_torch/metrics/text.py",
            "dig_tpu_torch/models/decoder.py", "dig_tpu_torch/ops/images.py",
            "dig_tpu_torch/parallel/dist.py", "dig_tpu_torch/parallel/mesh.py",
            "dig_tpu_torch/parallel/sharding.py", "dig_tpu_torch/parallel/tensor.py",
            "dig_tpu_torch/cli/run_pretrain_multihost.py", "dig_tpu_torch/utils/flops.py",
            "dig_tpu_torch/utils/export_torch.py", "dig_tpu_torch/tools/export_pth.py",
            "dig_tpu_torch/tools/create_lmdb.py", "dig_tpu_torch/tools/gen_synth.py",
            "dig_tpu_torch/tools/gen_voc.py", "bench_torch.py",
            "tools/time_attention_bwd.py", "tools/time_layernorm_bwd.py",
            "tools/time_pretrain_cli.py", "tools/time_gloo_collectives.py"} <= names
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dig_tpu")]
    assert bad == []
