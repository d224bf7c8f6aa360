"""The CLIs of the port against `dig_tpu`'s for the models the JAX package
adds on top of the reference, on the CPU: fine-tuning with the auxiliary
MIM branch (`--model_kind mim_rec`) and with feature distillation
(`--use_feat_distill --teacher_ckpt`), and batch inference of a CTC and a
GRU-head recognizer; plus the refusals that stay.  Setup and tolerances:
`tests/_torch_port_kinds_cli.py`.

The MIM step's masks are the test's on both sides
(`random_mask_batch`, which each step takes from its package's
`data.masking`).  The teacher is one set of weights in the form each
package reads: a native checkpoint directory for `dig_tpu`, which only JAX
unpickles, and a recognizer `.pth` for the port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_kinds_cli import (
    MICRO,
    assert_train_logs_match,
    make_data,
    png,
    run_both,
    run_jax,
    write_lmdb,
)
from dig_tpu_torch.cli import run_finetune as tcli
from dig_tpu_torch.config import FinetuneConfig, parse_config
from dig_tpu_torch.data import masking as tmasking
from dig_tpu_torch.ops import activations as tact
from dig_tpu_torch.utils.convert import params_from_jax

NUM_MIM = 4  # round(0.5 * 8) rows masked a step


@pytest.fixture(autouse=True)
def _one_thread_and_gelu():
    n, exact = torch.get_num_threads(), tact.EXACT
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tact.set_exact(exact)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("aux_data"))


def _mask():
    m = np.zeros((NUM_MIM, 1, 256), bool)
    rng = np.random.default_rng(80)
    for row in m:
        row[0, rng.permutation(256)[:int(0.7 * 256)]] = True
    return m


def _fixed_masks(mp):
    mask = _mask()
    mp.setattr("dig_tpu.data.masking.random_mask_batch",
               lambda key, b, n, num_mask, v=1: jnp.asarray(mask[:b]))
    mp.setattr(tmasking, "random_mask_batch",
               lambda gen, b, n, num_mask, v=1: torch.from_numpy(mask[:b]))


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A recognizer's weights (JAX init, seed 7) as a native dig_tpu
    directory and as a port `.pth`."""
    from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
    from dig_tpu.train.state import TrainState as JTrainState
    from dig_tpu.utils.checkpoint import save_checkpoint as j_save

    root = tmp_path_factory.mktemp("teacher")
    jm = j_build_rec_model(MICRO, "small_tf_decoder")
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(7), jnp.zeros((2, 32, 128, 3)), jnp.zeros((2, 25), jnp.int32),
        jnp.ones((2,), jnp.int32), True)["params"])
    native = j_save(str(root), "t", JTrainState.create(params, optax.identity()))
    torch.save({"model": params_from_jax(params)}, root / "teacher.pth")
    return dict(native=native, pth=str(root / "teacher.pth"))


@pytest.fixture(scope="module", params=["distill", "mim_rec", "mim_rec_proj"])
def runs(request, data, teacher, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    model = ["--decoder_name", "small_tf_decoder", "--eval_data_path", data["eval"]]
    if request.param == "distill":
        jlog, tlog, screen = run_both(root, data, model + ["--use_feat_distill"],
                                      jax_argv=["--teacher_ckpt", teacher["native"]],
                                      port_argv=["--teacher_ckpt", teacher["pth"]])
    else:
        extra = ["--use_mim_proj"] if request.param == "mim_rec_proj" else []
        jlog, tlog, screen = run_both(root, data, model + ["--model_kind", "mim_rec"] + extra,
                                      patch=_fixed_masks)
    return dict(name=request.param, jlog=jlog, tlog=tlog, screen=screen)


def test_train_logs_match_jax(runs):
    assert_train_logs_match(runs["jlog"], runs["tlog"])
    tl = runs["tlog"][0]
    extra = "train_loss_distill" if runs["name"] == "distill" else "train_loss_pixel"
    assert tl[extra] > 0


def test_eval_matches_jax(runs):
    jl, tl = runs["jlog"][0], runs["tlog"][0]
    assert tl["val_acc"] == jl["val_acc"] and tl["max_accuracy"] == jl["max_accuracy"]
    assert "train: 32 imgs, 4 steps/epoch" in runs["screen"]


def test_teacher_is_read_like_finetune(data, teacher, tmp_path):
    """The port's teacher: a recognizer `.pth` (or a port directory) loaded as
    `--finetune` loads, into a model of the student's configuration without
    the projector, and never trained."""
    cfg = parse_config(FinetuneConfig, ["--model", MICRO, "--decoder_name", "small_tf_decoder",
                                        "--use_feat_distill", "--teacher_ckpt", teacher["pth"],
                                        "--dtype", "float32"])
    student = tcli.build_model(cfg, "cpu")
    step = tcli.make_step(cfg, student, "cpu")
    assert step.__qualname__.startswith("make_distill_finetune_step")
    t_model = tcli.build_model(cfg, "cpu", use_feat_distill=False)
    assert tcli.load_finetune_init(cfg, t_model, teacher["pth"]) == len(t_model.state_dict())
    assert not hasattr(t_model, "feat_proj") and hasattr(student, "feat_proj")


def test_mim_rec_with_a_pretrain_name_is_refused_by_both(data, tmp_path):
    argv = ["--model", "pretrain_simmim_moco_ori_vit_micro_patch4_32x128", "--model_kind",
            "mim_rec", "--data_path", data["train"], "--dtype", "float32",
            "--num_workers", "1"]
    with pytest.raises(ValueError, match="pretrain model"):
        run_jax(argv + ["--output_dir", str(tmp_path / "jax")])
    with pytest.raises(ValueError, match="pretrain model"):
        tcli.main(parse_config(FinetuneConfig, argv + ["--output_dir", str(tmp_path / "port")]),
                  device="cpu")


def test_distillation_without_a_teacher_is_refused_by_both(data, tmp_path):
    argv = ["--model", MICRO, "--use_feat_distill", "--data_path", data["train"],
            "--dtype", "float32"]
    with pytest.raises(ValueError, match="teacher_ckpt"):
        run_jax(argv + ["--output_dir", str(tmp_path / "jax")])
    with pytest.raises(ValueError, match="teacher_ckpt"):
        tcli.main(parse_config(FinetuneConfig, argv + ["--output_dir", str(tmp_path / "port")]),
                  device="cpu")


# ---------------------------------------------------------------------------
# batch inference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def predict_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    rng = np.random.default_rng(90)
    images = [rng.integers(0, 256, (32, 100 + 7 * i, 3), dtype=np.uint8) for i in range(5)]
    (root / "imgs").mkdir()
    for i, img in enumerate(images[:2]):
        (root / "imgs" / f"{i}.png").write_bytes(png(img))
    write_lmdb(root / "db", images[2:], ["x"] * 3)
    return root


def _tsv(path):
    rows = [line.rstrip("\n").split("\t") for line in open(path)]
    return [(name, text, float(conf)) for name, text, conf in rows]


@pytest.mark.parametrize("kind", ["ctc", "attn"])
def test_predict_tsv_matches_jax(kind, predict_inputs, monkeypatch, tmp_path):
    """Both predict CLIs on 2 files and a 3-record LMDB at batch 2 (a short
    last batch): the same names and texts, confidences within 1e-4.  The
    GRU head enters both as a reference `.pth` (`dig_tpu` converts it,
    merging the r and z biases; the port loads it as it is); the CTC head,
    which has no reference layout, enters `dig_tpu` as its parameter tree."""
    from dig_tpu.cli import run_predict as jpredict
    from dig_tpu.config import PredictConfig as JPredictConfig
    from dig_tpu.config import parse_config as j_parse
    from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
    from dig_tpu_torch.cli.run_predict import main as t_main
    from dig_tpu_torch.config import PredictConfig

    jm = j_build_rec_model(MICRO, model_kind=kind)
    rng = np.random.default_rng(91)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p)).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                *(() if kind == "ctc" else (jnp.zeros((2, 25), jnp.int32),
                                            jnp.ones((2,), jnp.int32))), True)["params"])
    sd = params_from_jax(params)
    if kind == "attn":  # a reference .pth keeps a bias of its own on each hidden gate
        h = 512
        sd["decoder.decoder.gru.bias_hh_l0"][: 2 * h] = torch.from_numpy(
            rng.normal(0, 0.05, 2 * h).astype(np.float32))
        sd["decoder.decoder.gru.bias_ih_l0"][: 2 * h] -= sd["decoder.decoder.gru.bias_hh_l0"][
            : 2 * h]
    pth = tmp_path / "w.pth"
    torch.save({"model": sd}, pth)
    argv = ["--model", MICRO, "--model_kind", kind, "--images", str(predict_inputs / "imgs"),
            "--data_path", str(predict_inputs / "db"), "--batch_size", "2", "--num_workers", "1",
            "--dtype", "float32", "--finetune", str(pth)]
    if kind == "ctc":
        monkeypatch.setattr(jpredict, "load_params", lambda cfg, model: params)
    from dig_tpu.ops import activations as jact

    exact = jact.EXACT
    try:
        jpredict.main(j_parse(JPredictConfig, argv + ["--output", str(tmp_path / "jax.tsv")]))
    finally:
        jact.set_exact(exact)
    t_main(parse_config(PredictConfig, argv + ["--output", str(tmp_path / "port.tsv")]),
           device="cpu")
    want, got = _tsv(tmp_path / "jax.tsv"), _tsv(tmp_path / "port.tsv")
    assert len(got) == len(want) == 5
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], atol=1e-4)
    assert all(0 < r[2] <= 1 for r in got)
