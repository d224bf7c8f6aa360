"""The pre-training slice as a whole: the port's `run_pretrain.main` against
the JAX package's, on the CPU, from the same weights and the same batches.

One LMDB of seeded PNG word images; the micro model in fp32; one loader
thread and host augmentation, where both loaders give the same batches
byte for byte (tests/test_torch_port_data.py).  The port's seeded state
dict is carried into a `dig_tpu` checkpoint (`convert_torch_moco` +
`dig_tpu.utils.checkpoint.save_checkpoint`, ``extra={"epoch": -1}``) and
into a port checkpoint, and both CLIs start from theirs with `--resume`.
The JAX CLI runs on the test harness's 8 CPU devices at batch 1 a device;
the port at batch 8 on one: the same global batch, the same learning rate.

Also here: `--device_aug` runs and resumes, every refusal, drop-path's
generator, the mid-epoch checkpoint.  Tolerances are stated where used.
"""

import json
import os
import signal
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from dig_tpu.cli import run_pretrain as jcli
from dig_tpu.config import PretrainConfig as JPretrainConfig
from dig_tpu.config import parse_config as j_parse_config
from dig_tpu.train.pretrain import init_pretrain_state as j_init_pretrain_state
from dig_tpu.utils.checkpoint import convert_torch_moco
from dig_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from dig_tpu_torch.cli import run_pretrain as tcli
from dig_tpu_torch.config import PretrainConfig, parse_config
from dig_tpu_torch.data.lmdb_store import LmdbWriter
from dig_tpu_torch.models.moco import build_pretrain_model
from dig_tpu_torch.optim import create_optimizer
from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils import checkpoint as ckpt
from dig_tpu_torch.utils.convert import moco_params_from_jax
from dig_tpu_torch.utils.rng import step_generator

NAME = "pretrain_simmim_moco_ori_vit_micro_patch4_32x128"
N_IMAGES = 32
GLOBAL_BATCH = 8
# absolute lr = lr * 8 / 256 = 1e-3, reached after 2 warm-up steps; eps 1e-3
# keeps AdamW's m / (sqrt(v) + eps) from turning a gradient that is zero but
# for rounding (the patch extractor's last LayerNorm shift) into a full step
COMMON = ["--model", NAME, "--epochs", "2", "--warmup_steps", "2", "--lr", "0.032",
          "--opt_eps", "1e-3", "--moco_mlp_dim", "32", "--moco_dim", "16", "--num_windows", "4",
          "--contrast_warmup_steps", "2", "--num_workers", "1", "--dtype", "float32",
          "--seed", "0"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lmdb_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pretrain_cli") / "words")
    rng = np.random.default_rng(0)
    with LmdbWriter(path) as w:
        for i in range(1, N_IMAGES + 1):
            img = rng.integers(0, 256, (24 + 8 * (i % 4), 60 + 12 * (i % 9), 3), dtype=np.uint8)
            ok, buf = cv2.imencode(".png", img)
            assert ok
            w.put(b"image-%09d" % i, buf.tobytes())
        w.put(b"num-samples", str(N_IMAGES).encode())
    return path


def _port_cfg(lmdb_path, out, *extra, batch=GLOBAL_BATCH):
    return parse_config(PretrainConfig, COMMON + ["--image_alone_path", lmdb_path, "--batch_size",
                                                  str(batch), "--output_dir", str(out), *extra])


def _log(out):
    with open(os.path.join(str(out), "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def both_runs(lmdb_path, tmp_path_factory):
    """Both CLIs, two epochs of four steps from the same weights."""
    root = tmp_path_factory.mktemp("both")
    n_dev = jax.device_count()
    assert GLOBAL_BATCH % n_dev == 0
    # the port's seeded weights, the momentum branch moved off the student
    model = build_pretrain_model(NAME, seed=3, device="cpu", mlp_dim=32, dim=16, num_windows=4)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if not p.requires_grad:
                p.mul_(0.9)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    opt = create_optimizer("adamw", model.named_parameters(), [1e-3], [0.1])
    port_init = ckpt.save_checkpoint(str(root / "port_init"), "init",
                                     TrainState(model=model, optimizer=opt), extra={"epoch": -1})

    jargv = COMMON + ["--image_alone_path", lmdb_path, "--batch_size", str(GLOBAL_BATCH // n_dev),
                      "--output_dir", str(root / "jax_out")]
    jcfg = j_parse_config(JPretrainConfig, jargv)
    jmodel = jcli.build_model(jcfg)
    from dig_tpu.optim import create_optimizer as j_create_optimizer

    tx = j_create_optimizer("adamw", np.full(8, 1e-3, np.float32), np.full(8, 0.1, np.float32),
                            betas=jcfg.opt_betas, eps=jcfg.opt_eps, clip_grad=jcfg.clip_grad)
    trees = convert_torch_moco({k: v.numpy() for k, v in start.items()})
    jstate = j_init_pretrain_state(jmodel, tx, jax.random.PRNGKey(0))
    as_jax = lambda tree: jax.tree_util.tree_map(jax.numpy.asarray, tree)
    jstate = jstate.replace(params=as_jax(trees["student"]), ema_params=as_jax(trees["ema"]))
    j_save_checkpoint(str(root / "jax_init"), "init", jstate, extra={"epoch": -1})

    stdout, handlers = sys.stdout, {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:  # the JAX CLI leaves its tee and its signal handlers installed
        jcfg.resume = str(root / "jax_init" / "checkpoint-init")
        jfinal = jcli.main(jcfg)
    finally:
        tee, sys.stdout = sys.stdout, stdout
        if tee is not stdout:
            tee.file.close()
        for s, h in handlers.items():
            signal.signal(s, h)

    tfinal = tcli.main(_port_cfg(lmdb_path, root / "port_out", "--resume", port_init),
                       device="cpu")
    assert sys.stdout is stdout  # the port puts the stream back itself
    return dict(root=root, start=start, jfinal=jfinal, tfinal=tfinal,
                jlog=_log(root / "jax_out"), tlog=_log(root / "port_out"))


def test_cli_logs_match_jax(both_runs):
    jlog, tlog = both_runs["jlog"], both_runs["tlog"]
    assert len(jlog) == len(tlog) == 2
    for jl, tl in zip(jlog, tlog):
        assert sorted(tl) == sorted(jl)  # the same keys (a jitted step returns its dict sorted)
        assert tl["epoch"] == jl["epoch"] and tl["n_parameters"] == jl["n_parameters"]
        # fp32 through the whole graph, the averages of an epoch's first and
        # last step: 1e-4 relative
        for k in ("train_loss", "train_loss_contrast", "train_loss_pixel", "train_grad_norm"):
            assert np.isfinite(tl[k])
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, err_msg=k)
        assert tl["train_moco_m"] == pytest.approx(jl["train_moco_m"], rel=1e-6)
    assert tlog[0]["train_loss"] != tlog[1]["train_loss"]


def test_cli_final_parameters_match_jax(both_runs):
    """After 8 AdamW steps from the same weights: every leaf, student and
    momentum branch, within 1e-4 of that leaf's largest value; and moved.
    One leaf starts at zero and has a gradient that is zero but for rounding
    (the patch extractor's last LayerNorm shift, which the projection
    head's first BN removes): it holds ~1e-9 of noise on both sides, and a
    floor of 1e-6 of the largest parameter covers it."""
    jfinal, tfinal = both_runs["jfinal"], both_runs["tfinal"]
    assert int(jfinal.step) == tfinal.step == tfinal.optimizer.count == 8
    want = moco_params_from_jax(jax.tree_util.tree_map(np.asarray, jfinal.params),
                                jax.tree_util.tree_map(np.asarray, jfinal.ema_params))
    got = tfinal.model.state_dict()
    assert sorted(want) == sorted(got)
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err, scale = float((got[name] - w).abs().max()), float(w.abs().max())
        assert err <= 1e-4 * scale + floor, f"{name}: {err:.3e} vs max {scale:.3e}"
        assert not torch.equal(got[name], both_runs["start"][name]), name


def test_cli_outputs_on_disk(both_runs):
    out = both_runs["root"] / "port_out"
    assert sorted(os.listdir(out)) == ["checkpoint-0", "checkpoint-1", "log.txt", "screen.txt", "tb"]
    for epoch in (0, 1):
        with open(out / f"checkpoint-{epoch}" / "meta.json") as f:
            assert json.load(f) == {"step": 4 * (epoch + 1), "extra": {"epoch": epoch}}
    screen = (out / "screen.txt").read_text()
    assert '"batch_size": 8' in screen and "dataset: 32 imgs, 4 steps/epoch" in screen
    assert "Epoch: [1] [3/4]" in screen and "Averaged stats:" in screen
    # the saved final checkpoint is the returned state
    payload = ckpt.restore_checkpoint(str(out / "checkpoint-1"))
    final = both_runs["tfinal"].model.state_dict()
    assert all(torch.equal(payload["model"][k], final[k]) for k in final)


def test_cli_auto_resumes_where_it_stopped(both_runs, lmdb_path, tmp_path):
    """One epoch, then a second `main` with `--epochs 2` in the same
    directory: it restores checkpoint-0 and runs epoch 1 only.  Host
    augmentation on one thread is a function of the seed and the epoch's
    thread, so the resumed run is not held against the straight one here
    (the `--device_aug` test below does that); its schedules are."""
    out = tmp_path / "out"
    init = str(both_runs["root"] / "port_init" / "checkpoint-init")
    first = _port_cfg(lmdb_path, out, "--resume", init)
    first.epochs = 1
    tcli.main(first, device="cpu")
    assert [l["epoch"] for l in _log(out)] == [0]
    state = tcli.main(_port_cfg(lmdb_path, out), device="cpu")
    assert [l["epoch"] for l in _log(out)] == [0, 1]
    assert state.step == state.optimizer.count == 8
    assert "auto-resumed from" in (out / "screen.txt").read_text()
    # a third call finds both epochs done and trains nothing
    again = tcli.main(_port_cfg(lmdb_path, out), device="cpu")
    assert again.step == 8 and len(_log(out)) == 2


def test_cli_device_aug_runs_and_resume_equals_the_straight_run(lmdb_path, tmp_path):
    """With `--device_aug` the run is a function of (seed, step): two
    epochs straight equal one epoch + auto-resume + one epoch, bit for bit
    (drop-path on, so the train step's generators are replayed too)."""
    extra = ("--device_aug", "--drop_path", "0.1")
    straight = tcli.main(_port_cfg(lmdb_path, tmp_path / "a", *extra), device="cpu")
    # the schedules span both epochs in both runs; only the loop stops early
    assert _run_first_epochs(_port_cfg(lmdb_path, tmp_path / "b", *extra), 1) == 4
    resumed = tcli.main(_port_cfg(lmdb_path, tmp_path / "b", *extra), device="cpu")
    assert resumed.step == straight.step == 8
    sa, sb = straight.model.state_dict(), resumed.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa = straight.optimizer.inner.state_dict()["state"]
    ob = resumed.optimizer.inner.state_dict()["state"]
    for i in oa:
        for name in oa[i]:
            assert torch.equal(oa[i][name], ob[i][name]), (i, name)
    la, lb = _log(tmp_path / "a"), _log(tmp_path / "b")
    assert la == lb and all(np.isfinite(l["train_loss"]) for l in la)


def _run_first_epochs(cfg, n):
    """`main` over the first `n` epochs of a run whose schedules span
    `cfg.epochs`: the loop is cut by an exception from the epoch's log
    write, as a job killed after its checkpoint would be cut.  Returns the
    step count in the checkpoint it left."""
    class Stop(Exception):
        pass

    real = tcli.JsonlLogger.write

    def write(self, **stats):
        real(self, **stats)
        if stats["epoch"] == n - 1:
            raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli.JsonlLogger, "write", write)
        with pytest.raises(Stop):
            tcli.main(cfg, device="cpu")
    payload = ckpt.restore_checkpoint(ckpt.latest_checkpoint(cfg.output_dir))
    assert payload["extra"] == {"epoch": n - 1}
    return payload["step"]


def test_cli_mid_epoch_checkpoint_and_pruning(lmdb_path, tmp_path):
    """16 steps an epoch at batch 2 with `--eval_freq 1`: a checkpoint
    every 10 steps under the tag {epoch}_{step}; `--keep_ckpt_max 1` prunes
    numeric tags only."""
    cfg = _port_cfg(lmdb_path, tmp_path / "out", "--eval_freq", "1", "--keep_ckpt_max", "1",
                    "--device_aug", batch=2)
    tcli.main(cfg, device="cpu")
    assert sorted(n for n in os.listdir(tmp_path / "out") if n.startswith("checkpoint")) == \
        ["checkpoint-0_10", "checkpoint-1", "checkpoint-1_10"]
    payload = ckpt.restore_checkpoint(str(tmp_path / "out" / "checkpoint-1_10"))
    assert payload["step"] == 16 + 11 and payload["extra"] == {"epoch": 1}


def test_cli_profile_steps_writes_a_trace(lmdb_path, tmp_path):
    out = tmp_path / "out"
    tcli.main(_port_cfg(lmdb_path, out, "--device_aug", "--profile_steps", "2",
                        "--profile_start_step", "1"), device="cpu")
    with open(out / "profile" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "[profile] trace of steps [1, 3)" in (out / "screen.txt").read_text()


def test_cli_sigterm_checkpoints_at_the_step_boundary_and_exits_0(lmdb_path, tmp_path):
    """SIGTERM during step 1 of epoch 0: checkpoint-0 with the mid-epoch
    state and extra epoch -1, exit 0, the handlers put back; the next run
    auto-resumes and redoes epoch 0."""
    calls = []
    real = tcli.make_pretrain_step

    def killer(*a, **k):
        step = real(*a, **k)

        def run(*args):
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*args)
        return run

    out = tmp_path / "out"
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "make_pretrain_step", killer)
        with pytest.raises(SystemExit) as exit_info:
            tcli.main(_port_cfg(lmdb_path, out, "--device_aug"), device="cpu")
    assert exit_info.value.code == 0 and len(calls) == 2
    assert signal.getsignal(signal.SIGTERM) is handler
    payload = ckpt.restore_checkpoint(str(out / "checkpoint-0"))
    assert payload["step"] == 2 and payload["extra"] == {"epoch": -1}
    state = tcli.main(_port_cfg(lmdb_path, out, "--device_aug"), device="cpu")
    assert state.step == 2 + 8 and "auto-resumed from" in (out / "screen.txt").read_text()


REFUSALS = {
    "n_fsdp": (["--n_fsdp", "2"], "n_fsdp"),
    "n_tensor": (["--n_tensor", "2"], "n_tensor"),
    "remat": (["--remat"], "remat"),
    "opt": (["--opt", "lamb"], "lamb"),
    "patchnet_name": (["--patchnet_name", "conv"], "ConvPatchNet"),
    "resume_remote": (["--resume", "gs://bucket/run/checkpoint-3"], "remote"),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_cli_refuses_what_is_not_ported(what, lmdb_path, tmp_path):
    argv, word = REFUSALS[what]
    with pytest.raises(NotImplementedError, match=f"(?s){word}.*ROADMAP.md"):
        tcli.main(_port_cfg(lmdb_path, tmp_path / "out", *argv), device="cpu")
    assert not os.path.exists(tmp_path / "out")  # refused before anything is written


def test_cli_refuses_a_native_dig_tpu_checkpoint(both_runs, lmdb_path, tmp_path):
    native = str(both_runs["root"] / "jax_out" / "checkpoint-1")
    assert os.path.exists(os.path.join(native, "arrays.npz"))
    with pytest.raises(NotImplementedError, match="(?s)native dig_tpu checkpoint.*ROADMAP.md"):
        tcli.main(_port_cfg(lmdb_path, tmp_path / "out", "--resume", native), device="cpu")


def test_cli_needs_a_card_unless_asked_for_the_cpu(lmdb_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    stdout = sys.stdout
    with pytest.raises(RuntimeError, match="no card is visible"):
        tcli.main(_port_cfg(lmdb_path, tmp_path / "out"))
    assert sys.stdout is stdout and not os.path.exists(tmp_path / "out")


def test_cli_restores_stdout_when_the_run_raises(lmdb_path, tmp_path):
    stdout = sys.stdout
    cfg = _port_cfg(lmdb_path, tmp_path / "out")
    cfg.num_view = 3  # finalize raises, after the tee is installed
    with pytest.raises(ValueError, match="num_view"):
        tcli.main(cfg, device="cpu")
    assert sys.stdout is stdout
    assert '"num_view": 3' in (tmp_path / "out" / "screen.txt").read_text()


# ---------------------------------------------------------------------------
# drop-path in the pre-training step
# ---------------------------------------------------------------------------

def _step_setup(drop_path_rate):
    model = build_pretrain_model(NAME, seed=1, device="cpu", mlp_dim=32, dim=16, num_windows=4,
                                 drop_path_rate=drop_path_rate)
    opt = create_optimizer("adamw", model.named_parameters(), [1e-3], [0.05])
    step = make_pretrain_step(model, [0.99], [0.1])
    rng = np.random.default_rng(2)
    batch = {"images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "mask": rng.random((4, 2, 256)) < 0.7}
    return init_pretrain_state(model, opt), step, batch


def test_drop_path_rates_rise_linearly_like_jax():
    model = build_pretrain_model("pretrain_simmim_moco_ori_vit_small_patch4_32x128", device="cpu",
                                 mlp_dim=32, dim=16, drop_path_rate=0.1)
    rates = [blk.drop_path_rate for blk in model.encoder.blocks]
    assert rates == [float(r) for r in np.linspace(0, 0.1, 12)]


def test_drop_path_draws_from_the_steps_generator_only():
    def loss(seed):
        state, step, batch = _step_setup(0.5)
        before = torch.get_rng_state()
        gen = None if seed is None else step_generator(1, 0, seed)
        _, metrics = step(state, batch, gen)
        assert torch.equal(torch.get_rng_state(), before)  # the global stream is untouched
        grads = [p.grad is not None for p in state.model.parameters() if p.requires_grad]
        assert all(grads)
        return float(metrics["loss"])

    assert loss(0) == loss(0)
    assert loss(0) != loss(1)
    # without a generator nothing is dropped: the step of a model at rate 0
    state, step, batch = _step_setup(0.0)
    assert loss(None) == float(step(state, batch)[1]["loss"])


def test_no_draw_at_drop_path_zero():
    state, step, batch = _step_setup(0.0)
    gen = step_generator(1, 0, 0)
    before = gen.get_state()
    _, with_gen = step(state, batch, gen)
    assert torch.equal(gen.get_state(), before)
    state, step, batch = _step_setup(0.0)
    _, without = step(state, batch)
    assert {k: float(v) for k, v in with_gen.items()} == {k: float(v) for k, v in without.items()}
    assert with_gen["moco_m"].device == next(state.model.parameters()).device
