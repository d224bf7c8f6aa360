"""The fine-tuning CLI of the port against `dig_tpu`'s for the reference's
own recognizer variants, on the CPU, from the same weights and batches:
the GRU attention head in the reference's spelling (`--decoder_type
attention`), CTC (`--model_kind ctc`) and the sequence-class-token
recognizer (`--use_seq_cls_token`).  Setup and tolerances:
`tests/_torch_port_kinds_cli.py`.

Two faults of the JAX CLI shape what is compared.  It scores its
end-of-epoch eval of a CTC model with word accuracy of the raw frame ids
(it passes `ctc_accuracy` only to the mid-epoch eval), so the CTC runs
compare the training logs and the port's eval is held to `ctc_accuracy`
of its own ids; and its eval of `--model_kind seq_cls` raises (it asks
`SeqClsTokenRecModel.recognize` for presence logits the model does not
have), so the JAX seq_cls run has no eval set and the port's runs one."""

import numpy as np
import pytest
import torch

from _torch_port_kinds_cli import (
    N_EVAL,
    assert_train_logs_match,
    make_data,
    run_both,
)
from dig_tpu_torch.cli import run_finetune as tcli
from dig_tpu_torch.config import FinetuneConfig, parse_config
from dig_tpu_torch.ops import activations as tact

CASES = {
    "attention": (["--decoder_type", "attention"], True),
    "ctc": (["--model_kind", "ctc"], True),
    "seq_cls": (["--use_seq_cls_token"], False),
}


@pytest.fixture(autouse=True)
def _one_thread_and_gelu():
    n, exact = torch.get_num_threads(), tact.EXACT
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tact.set_exact(exact)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("kinds_data"))


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, data, tmp_path_factory):
    argv, jax_evals = CASES[request.param]
    ev = ["--eval_data_path", data["eval"]]
    root = tmp_path_factory.mktemp(request.param)
    jlog, tlog, screen = run_both(root, data, argv, jax_argv=ev if jax_evals else (),
                                  port_argv=ev)
    return dict(name=request.param, jlog=jlog, tlog=tlog, screen=screen, root=root)


def test_train_logs_match_jax(runs):
    assert_train_logs_match(runs["jlog"], runs["tlog"])
    assert runs["tlog"][0]["train_loss"] > 0


def test_eval_matches_jax(runs):
    """The port's eval line on the eval LMDB; against the JAX CLI's where
    that one scores the kind correctly (the GRU head)."""
    tl = runs["tlog"][0]
    assert f"images, Acc" in runs["screen"] and f": {N_EVAL} images" in runs["screen"]
    assert 0.0 <= tl["val_acc"] <= 1.0
    if runs["name"] == "attention":
        jl = runs["jlog"][0]
        assert tl["val_acc"] == jl["val_acc"] and tl["max_accuracy"] == jl["max_accuracy"]


def test_outputs_and_steps(runs):
    screen = runs["screen"]
    assert "train: 32 imgs, 4 steps/epoch" in screen and "Epoch: [0] [3/4]" in screen
    out = runs["root"] / "port"
    assert (out / "checkpoint-0" / "checkpoint.pth").exists()


def test_ctc_eval_scores_collapsed_frames(data, tmp_path):
    """`--eval` of a CTC checkpoint: the accuracy is `ctc_accuracy` of the
    per-frame argmax (the CTC eval step), which the reference's metric
    computes (evaluation_metric/metrics.py:205-251)."""
    from dig_tpu_torch.data.dataset import build_dataset
    from dig_tpu_torch.metrics.text import ctc_accuracy
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.ops.images import to_model_images
    from dig_tpu_torch.utils.charset import build_charset

    model = build_rec_model("vit_micro_patch4_32x128", model_kind="ctc", seed=3, device="cpu")
    pth = tmp_path / "ctc.pth"
    torch.save({"model": model.state_dict()}, pth)
    cfg = parse_config(FinetuneConfig, [
        "--model", "vit_micro_patch4_32x128", "--model_kind", "ctc", "--eval",
        "--eval_data_path", data["eval"], "--batch_size", "4", "--num_workers", "1",
        "--dtype", "float32", "--output_dir", str(tmp_path / "out"), "--finetune", str(pth)])
    (result,) = tcli.main(cfg, device="cpu")
    ds = build_dataset(data["eval"], is_train=False, voc_type="ALLCASES_SYMBOLS", max_len=25)
    images = np.stack([ds[i][0] for i in range(len(ds))])
    targets = np.stack([ds[i][1] for i in range(len(ds))])
    tact.set_exact(True)  # the CLI read a .pth
    with torch.no_grad():
        ids = model(to_model_images(torch.from_numpy(images)), deterministic=True).argmax(-1)
    want = ctc_accuracy(ids.numpy(), targets, build_charset("ALLCASES_SYMBOLS", 25))
    assert result["n"] == N_EVAL and result["acc"] == pytest.approx(want, abs=1e-12)


def test_decoupled_eval_prints_the_multi_label_f_measure(data, tmp_path):
    """`--eval` of the decoupled recognizer: the presence logits of its
    multi-label head scored against the presence of every target id
    (padding included), averaged over the rows, as the reference's evaluate
    does (engine_for_finetuning.py:262-269)."""
    from dig_tpu_torch.data.dataset import build_dataset
    from dig_tpu_torch.metrics.text import multi_label_f_measure
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.ops.images import to_model_images

    model = build_rec_model("vit_micro_patch4_32x128", "decoupled_tf_decoder", seed=4,
                            device="cpu")
    from dig_tpu_torch.optim import create_optimizer
    from dig_tpu_torch.train.finetune import init_finetune_state
    from dig_tpu_torch.utils.checkpoint import save_checkpoint

    with torch.no_grad():  # queries that attend apart: presence logits of both signs
        model.multi_label.cls_queries.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(5))
    # the whole model, the multi-label head included (a reference-layout .pth
    # has no place for that head: neither package's converter reads it)
    ckpt = save_checkpoint(str(tmp_path), 0, init_finetune_state(
        model, create_optimizer("adamw", model.named_parameters(), [1e-4])))
    cfg = parse_config(FinetuneConfig, [
        "--model", "vit_micro_patch4_32x128", "--decoder_name", "decoupled_tf_decoder", "--eval",
        "--eval_data_path", data["eval"], "--batch_size", "8", "--num_workers", "1",
        "--dtype", "float32", "--output_dir", str(tmp_path / "out"), "--resume", ckpt])
    (result,) = tcli.main(cfg, device="cpu")
    ds = build_dataset(data["eval"], is_train=False, voc_type="ALLCASES_SYMBOLS", max_len=25)
    images = np.stack([ds[i][0] for i in range(len(ds))])
    targets = np.stack([ds[i][1] for i in range(len(ds))])
    want, n = 0.0, 0
    for lo in range(0, len(ds), 8):  # the CLI's batches: one F-measure each, weighted by rows
        x = to_model_images(torch.from_numpy(images[lo:lo + 8]))
        _, _, cls_logit = model.recognize(x, 0, -1, with_cls=True)
        rows = targets[lo:lo + 8]
        presence = np.zeros((len(rows), 97), np.float32)
        presence[np.arange(len(rows))[:, None], rows] = 1.0
        want += multi_label_f_measure(cls_logit.numpy(), presence) * len(rows)
        n += len(rows)
    assert result["n"] == N_EVAL
    assert result["multi_label_fmeasure"] == pytest.approx(want / n, abs=1e-9)
    assert 0 < result["multi_label_fmeasure"] < 1
    screen = (tmp_path / "out" / "screen.txt").read_text()
    assert f"F_measure: {result['multi_label_fmeasure']:.4f}" in screen
