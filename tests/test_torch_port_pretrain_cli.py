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


def _run_jax(jcfg):
    """`dig_tpu.cli.run_pretrain.main`, with stdout and the signal handlers
    put back afterwards (the JAX CLI leaves its tee and handlers installed)."""
    stdout, handlers = sys.stdout, {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return jcli.main(jcfg)
    finally:
        tee, sys.stdout = sys.stdout, stdout
        if tee is not stdout:
            tee.file.close()
        for s, h in handlers.items():
            signal.signal(s, h)


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

    jcfg.resume = str(root / "jax_init" / "checkpoint-init")
    stdout = sys.stdout
    jfinal = _run_jax(jcfg)
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
    "n_fsdp": (["--n_fsdp", "2"], NotImplementedError, "(?s)n_fsdp.*ROADMAP.md"),
    "n_tensor": (["--n_tensor", "2"], NotImplementedError, "(?s)n_tensor.*ROADMAP.md"),
    "opt": (["--opt", "lamb_x"], ValueError, "Invalid optimizer 'lamb_x'"),  # as dig_tpu
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_cli_refuses_what_is_not_ported(what, lmdb_path, tmp_path):
    """Parameter sharding is not ported; an optimizer name `dig_tpu` does
    not know is refused as `dig_tpu` refuses it.  Every other option runs
    (`test_cli_runs_the_options_dig_tpu_runs`)."""
    argv, exc, word = REFUSALS[what]
    with pytest.raises(exc, match=word):
        tcli.main(_port_cfg(lmdb_path, tmp_path / "out", *argv), device="cpu")
    assert not os.path.exists(tmp_path / "out")  # refused before anything is written


OPTIONS = ["--opt", "lamb", "--patchnet_name", "conv", "--remat"]


@pytest.fixture(scope="module")
def option_runs(lmdb_path, tmp_path_factory):
    """Both CLIs with `--opt lamb --patchnet_name conv --remat`, two epochs
    of four steps from the same weights (the conv extractor's carried by
    `convert_torch_moco`), each resuming its own package's init checkpoint
    with a LAMB state."""
    root = tmp_path_factory.mktemp("options")
    model = build_pretrain_model(NAME, seed=4, device="cpu", mlp_dim=32, dim=16, num_windows=4,
                                 patchnet_name="conv")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = create_optimizer("lamb", model.named_parameters(), [1e-3], [0.1])
    port_init = ckpt.save_checkpoint(str(root / "port_init"), "init",
                                     TrainState(model=model, optimizer=opt), extra={"epoch": -1})
    n_dev = jax.device_count()
    jargv = COMMON + OPTIONS + ["--image_alone_path", lmdb_path, "--batch_size",
                                str(GLOBAL_BATCH // n_dev), "--output_dir", str(root / "jax_out")]
    jcfg = j_parse_config(JPretrainConfig, jargv)
    from dig_tpu.optim import create_optimizer as j_create_optimizer

    tx = j_create_optimizer("lamb", np.full(8, 1e-3, np.float32), np.full(8, 0.1, np.float32))
    trees = convert_torch_moco({k: v.numpy() for k, v in start.items()})
    jstate = j_init_pretrain_state(jcli.build_model(jcfg), tx, jax.random.PRNGKey(0))
    as_jax = lambda tree: jax.tree_util.tree_map(jax.numpy.asarray, tree)  # noqa: E731
    jstate = jstate.replace(params=as_jax(trees["student"]), ema_params=as_jax(trees["ema"]))
    j_save_checkpoint(str(root / "jax_init"), "init", jstate, extra={"epoch": -1})
    jcfg.resume = str(root / "jax_init" / "checkpoint-init")
    jfinal = _run_jax(jcfg)
    tfinal = tcli.main(_port_cfg(lmdb_path, root / "port_out", *OPTIONS, "--resume", port_init),
                       device="cpu")
    return dict(root=root, start=start, jfinal=jfinal, tfinal=tfinal,
                jlog=_log(root / "jax_out"), tlog=_log(root / "port_out"))


def _memory_copy(local_dir, url):
    """A local checkpoint directory copied onto fsspec's in-memory filesystem."""
    import fsspec

    fs, root = fsspec.core.url_to_fs(url)
    for name in os.listdir(local_dir):
        with open(os.path.join(local_dir, name), "rb") as f, fs.open(f"{root}/{name}", "wb") as g:
            g.write(f.read())
    return url


@pytest.mark.parametrize("what", ["opt", "patchnet_name", "remat", "resume_remote"])
def test_cli_runs_the_options_dig_tpu_runs(what, both_runs, option_runs, lmdb_path, tmp_path):
    """What the port once refused, held against `dig_tpu`:
    * opt, patchnet_name: both CLIs with `--opt lamb --patchnet_name conv
      --remat` from the same weights: the epoch logs' losses within 1e-4,
      the conv extractor in both, and every final leaf within 1e-3 of its
      largest value (plus the floor of `test_cli_final_parameters_match_jax`
      for the leaves whose gradient is zero but for rounding: here also the
      conv and head biases that a `BatchStatsNorm` follows).  AdamW's bound
      there is 1e-4; LAMB's trust ratio scales each step to lr x ||p||, for
      the wide conv kernels ~10x AdamW's lr per element, and the two
      packages' gradients (within 1e-4 of each leaf's max,
      tests/test_torch_port_conv_patchnet.py) move with it;
    * remat: `--remat --device_aug --drop_path 0.1` repeats the same run
      without `--remat` bit for bit (the recompute draws the forward's
      drop-path masks);
    * resume_remote: `--resume memory://...` (the init checkpoint copied
      onto fsspec's in-memory filesystem) repeats the `--resume` of the
      local directory bit for bit.
    The last two are held to the port's own runs, which `both_runs` holds
    to `dig_tpu`'s; `--device_aug` makes a run a function of (seed, step),
    which host augmentation on a thread is not."""
    if what in ("opt", "patchnet_name"):
        jfinal, tfinal = option_runs["jfinal"], option_runs["tfinal"]
        assert int(jfinal.step) == tfinal.step == tfinal.optimizer.count == 8
        assert tfinal.optimizer.rule == "lamb" and "p2g_dense0" in jfinal.params["patch_extractor"]
        if what == "patchnet_name":
            for jl, tl in zip(option_runs["jlog"], option_runs["tlog"]):
                for k in ("train_loss", "train_loss_contrast", "train_loss_pixel"):
                    np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, err_msg=k)
            return
        want = moco_params_from_jax(jax.tree_util.tree_map(np.asarray, jfinal.params),
                                    jax.tree_util.tree_map(np.asarray, jfinal.ema_params))
        got = tfinal.model.state_dict()
        assert sorted(want) == sorted(got)
        floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
        for name, w in want.items():
            err, scale = float((got[name] - w).abs().max()), float(w.abs().max())
            assert err <= 1e-3 * scale + floor, f"{name}: {err:.3e} vs max {scale:.3e}"
        return
    init = str(both_runs["root"] / "port_init" / "checkpoint-init")
    extra = ("--device_aug", "--drop_path", "0.1")
    ref = tcli.main(_port_cfg(lmdb_path, tmp_path / "ref", *extra, "--resume", init),
                    device="cpu")
    if what == "remat":
        run = tcli.main(_port_cfg(lmdb_path, tmp_path / "out", *extra, "--remat", "--resume",
                                  init), device="cpu")
    else:
        url = _memory_copy(init, f"memory://port-cli-{os.getpid()}/checkpoint-init")
        run = tcli.main(_port_cfg(lmdb_path, tmp_path / "out", *extra, "--resume", url),
                        device="cpu")
    want, got = ref.model.state_dict(), run.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert _log(tmp_path / "out") == _log(tmp_path / "ref")


def test_cli_resumes_a_native_dig_tpu_checkpoint(both_runs, lmdb_path, tmp_path):
    """`--resume` of the JAX CLI's own ``checkpoint-0``, a native directory
    read without JAX: the port's CLI runs epoch 1 from it; and from that
    state (params, momentum branch, AdamW's moments and count) the port's
    step takes the update `dig_tpu`'s step takes from its own restore of
    the directory, on one batch: the momentum branch within 1e-6 and the
    parameters' moves within 1e-3 of lr (the bounds of
    tests/test_torch_port_pretrain.py; wrong moments or count would move
    them by a whole step).  The CLI runs are not compared: host
    augmentation draws an epoch's views from where the epochs before left
    its generator, so a resumed run sees other views than a straight one."""
    native = str(both_runs["root"] / "jax_out" / "checkpoint-0")
    assert os.path.exists(os.path.join(native, "arrays.npz"))
    run = tcli.main(_port_cfg(lmdb_path, tmp_path / "out", "--resume", native), device="cpu")
    assert run.step == run.optimizer.count == 8
    log = _log(tmp_path / "out")
    assert [l["epoch"] for l in log] == [1] and np.isfinite(log[0]["train_loss"])

    from dig_tpu.optim import create_optimizer as j_create_optimizer
    from dig_tpu.train.pretrain import make_pretrain_step as j_make_pretrain_step
    from dig_tpu.utils.checkpoint import restore_checkpoint as j_restore_checkpoint

    lr, wd, mom, cw = (np.full(8, v, np.float32) for v in (1e-3, 0.1, 0.99, 0.1))
    jcfg = j_parse_config(JPretrainConfig, COMMON)
    jmodel = jcli.build_model(jcfg)
    payload = j_restore_checkpoint(native)
    jstate = j_init_pretrain_state(jmodel, j_create_optimizer("adamw", lr, wd, eps=1e-3),
                                   jax.random.PRNGKey(0))
    jstate = jstate.replace(params=payload["params"], opt_state=payload["opt_state"],
                            ema_params=payload["ema_params"],
                            step=jax.numpy.asarray(payload["step"], jax.numpy.int32))
    rng = np.random.default_rng(9)
    batch = {"images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "mask": np.zeros((4, 2, 256), bool)}
    for r in range(4):
        for v in range(2):
            batch["mask"][r, v, rng.permutation(256)[:179]] = True
    jnew, _ = j_make_pretrain_step(jmodel, mom, cw)(
        jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))

    model = build_pretrain_model(NAME, seed=5, device="cpu", mlp_dim=32, dim=16, num_windows=4)
    state = init_pretrain_state(model, create_optimizer("adamw", model.named_parameters(), lr,
                                                        wd, eps=1e-3))
    state = ckpt.load_into_state(state, ckpt.restore_checkpoint(native))
    assert state.step == state.optimizer.count == 4
    before = {k: v.clone() for k, v in model.state_dict().items()}
    make_pretrain_step(model, mom, cw)(state, batch)
    want = moco_params_from_jax(jax.tree_util.tree_map(np.asarray, jnew.params),
                                jax.tree_util.tree_map(np.asarray, jnew.ema_params))
    got = model.state_dict()
    for name, w in want.items():
        if name.startswith(("momentum_", "pix_projector_m")):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_allclose((got[name] - before[name]).numpy(),
                                       (w - before[name]).numpy(), rtol=0, atol=1e-3 * 1e-3,
                                       err_msg=name)


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
