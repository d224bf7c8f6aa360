"""The fine-tuning slice as a whole: the port's `run_finetune.main` against
the JAX package's, on the CPU, from the same weights and the same batches.

Two labelled LMDBs of seeded PNG images at the model's 32 x 128: a train set
of random words, and an eval set whose first half is labelled with the
port's own greedy reading of the image (so that accuracy is neither 0 nor
1, and a single differing id between the packages shows), the rest with
random words.  The micro recognizer in fp32, every rate 0 (the decoders'
hard-coded dropout set to 0 on both sides: torch and JAX random streams
cannot match), no augmentation, one loader thread; the weights enter both
CLIs as one reference-layout recognizer `.pth` (`--finetune`).  The JAX CLI
runs on the test harness's 8 CPU devices at batch 1 a device, the port at
batch 8 on one: the same global batch and learning rate.  One JAX CLI run
per module fixture.

Also here: gradient accumulation against optax `MultiSteps`, the three
`--finetune` sources, a port checkpoint read by `dig_tpu`, preemption,
the trace window, `--device_abi_aug` with resume, every refusal.
Tolerances are stated where used.
"""

import json
import os
import signal
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_threads import one_thread
from dig_tpu.cli import run_finetune as jcli
from dig_tpu.config import FinetuneConfig as JFinetuneConfig
from dig_tpu.config import parse_config as j_parse_config
from dig_tpu_torch.cli import run_finetune as tcli
from dig_tpu_torch.config import FinetuneConfig, parse_config
from dig_tpu_torch.data.lmdb_store import LmdbWriter
from dig_tpu_torch.models.moco import build_pretrain_model
from dig_tpu_torch.models.rec_model import build_rec_model
from dig_tpu_torch.ops import activations as tact
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.optim import create_optimizer
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils import checkpoint as ckpt
from dig_tpu_torch.utils.charset import build_charset
from dig_tpu_torch.utils.convert import params_from_jax

MODEL = ["--model", "vit_micro_patch4_32x128", "--decoder_name", "small_tf_decoder"]
N_TRAIN, N_EVAL, N_EVAL2 = 32, 13, 6
GLOBAL_BATCH = 8
EOS = 94
# absolute lr 1e-3 (lr * 8 / 256), layer decay over the micro encoder's 2
# blocks; eps 1e-3 keeps AdamW from turning a gradient that is zero but for
# rounding into a full step
RECIPE = ["--epochs", "2", "--lr", "0.032", "--opt_eps", "1e-3", "--layer_decay", "0.75",
          "--drop", "0", "--attn_drop_rate", "0", "--drop_path", "0", "--no_use_abi_aug",
          "--num_view", "1", "--num_workers", "1", "--dtype", "float32", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(autouse=True)
def _gelu():
    exact = tact.EXACT
    yield
    tact.set_exact(exact)


def _decoder_dropout_off(model):
    for m in model.decoder.modules():
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    return model


def _decoders_at_dropout_0(mp):
    """Both CLIs build their decoders at dropout 0."""
    real_t, real_j = tcli.build_model, jcli.build_model
    mp.setattr(tcli, "build_model", lambda cfg, device, **kw: _decoder_dropout_off(
        real_t(cfg, device, **kw)))
    mp.setattr(jcli, "build_model", lambda cfg: (lambda m: m.clone(
        decoder=m.decoder.clone(dropout=0.0)))(real_j(cfg)))


@pytest.fixture(autouse=True)
def _rates_zero(monkeypatch):
    _decoders_at_dropout_0(monkeypatch)


def _png(img):
    """RGB [H, W, 3] -> PNG bytes (cv2 writes BGR; the datasets decode to RGB)."""
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def _write_lmdb(path, images, words):
    with LmdbWriter(str(path)) as w:
        for i, (img, word) in enumerate(zip(images, words), start=1):
            w.put(b"image-%09d" % i, _png(img))
            w.put(b"label-%09d" % i, word.encode())
        w.put(b"num-samples", str(len(words)).encode())


def _random_words(rng, n, charset):
    return ["".join(charset.classes[j] for j in rng.integers(0, EOS, rng.integers(1, 9)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The recognizer `.pth` and the LMDBs (see the module docstring)."""
    root = tmp_path_factory.mktemp("finetune_cli")
    charset = build_charset("ALLCASES_SYMBOLS", 25)
    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=5, device="cpu")
    with torch.no_grad():
        model.decoder.classifier.bias[EOS] += 2.0  # readings of 1-4 characters
    torch.save({"model": model.state_dict()}, root / "rec.pth")
    rng = np.random.default_rng(0)
    shape = (32, 128, 3)
    train = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(N_TRAIN)]
    _write_lmdb(root / "train", train, _random_words(rng, N_TRAIN, charset))
    sets = {}
    for name, n in (("eval", N_EVAL), ("eval2", N_EVAL2)):
        images = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
        tact.set_exact(True)  # the CLIs read a .pth under erf GELU
        with torch.no_grad():
            _, ids = model.recognize(to_model_images(torch.from_numpy(np.stack(images))))
        tact.set_exact(False)
        read = [charset.decode(r) for r in ids.numpy()]
        words = [w if i < n // 2 and 0 < len(w) < 20 else rnd
                 for i, (w, rnd) in enumerate(zip(read, _random_words(rng, n, charset)))]
        _write_lmdb(root / name, images, words)
        sets[name] = str(root / name)
    return dict(root=root, pth=str(root / "rec.pth"), train=str(root / "train"), **sets)


def _log(out):
    with open(os.path.join(str(out), "log.txt")) as f:
        return [json.loads(line) for line in f]


def _port_cfg(data, out, *extra, batch=GLOBAL_BATCH, recipe=RECIPE):
    return parse_config(FinetuneConfig, MODEL + recipe + [
        "--data_path", data["train"], "--eval_data_path", data["eval"], "--finetune", data["pth"],
        "--batch_size", str(batch), "--output_dir", str(out), *extra])


def _run_jax(argv):
    """`dig_tpu.cli.run_finetune.main`, with stdout, the signal handlers
    and the GELU form put back afterwards (the JAX CLI leaves them set)."""
    from dig_tpu.ops import activations as jact

    stdout, exact = sys.stdout, jact.EXACT
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return jcli.main(j_parse_config(JFinetuneConfig, argv))
    finally:
        tee, sys.stdout = sys.stdout, stdout
        if tee is not stdout:
            tee.file.close()
        for s, h in handlers.items():
            signal.signal(s, h)
        jact.set_exact(exact)


@pytest.fixture(scope="module")
def both_runs(data, tmp_path_factory):
    """Both CLIs, two epochs of four steps from the same `.pth`, evaluated
    on the eval LMDB after each epoch."""
    root = tmp_path_factory.mktemp("both")
    n_dev = jax.device_count()
    assert GLOBAL_BATCH % n_dev == 0
    with pytest.MonkeyPatch.context() as mp:
        _decoders_at_dropout_0(mp)
        jfinal = _run_jax(MODEL + RECIPE + [
            "--data_path", data["train"], "--eval_data_path", data["eval"],
            "--finetune", data["pth"], "--batch_size", str(GLOBAL_BATCH // n_dev),
            "--output_dir", str(root / "jax_out")])
        stdout = sys.stdout
        tfinal = tcli.main(_port_cfg(data, root / "port_out"), device="cpu")
        assert sys.stdout is stdout and not tact.EXACT  # the port puts both back
    return dict(root=root, jfinal=jfinal, tfinal=tfinal, jlog=_log(root / "jax_out"),
                tlog=_log(root / "port_out"))


def test_cli_logs_match_jax(both_runs):
    jlog, tlog = both_runs["jlog"], both_runs["tlog"]
    assert len(jlog) == len(tlog) == 2
    for jl, tl in zip(jlog, tlog):
        assert sorted(tl) == sorted(jl)
        assert tl["epoch"] == jl["epoch"]
        # fp32 through the whole graph, the averages of an epoch's first and
        # last step: 1e-4 relative
        for k in ("train_loss", "train_grad_norm"):
            assert np.isfinite(tl[k])
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, err_msg=k)
        assert tl["train_class_acc"] == jl["train_class_acc"]
        assert tl["val_acc"] == jl["val_acc"] and tl["max_accuracy"] == jl["max_accuracy"]
    assert tlog[0]["train_loss"] != tlog[1]["train_loss"]


def test_cli_final_parameters_match_jax(both_runs):
    """After 8 AdamW steps from the same weights: every leaf within 1e-4 of
    its largest value (plus a floor of 1e-6 of the largest parameter)."""
    jfinal, tfinal = both_runs["jfinal"], both_runs["tfinal"]
    assert int(jfinal.step) == tfinal.step == tfinal.optimizer.count == 8
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jfinal.params))
    got = tfinal.model.state_dict()
    assert sorted(want) == sorted(got)
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err, scale = float((got[name] - w).abs().max()), float(w.abs().max())
        assert err <= 1e-4 * scale + floor, f"{name}: {err:.3e} vs max {scale:.3e}"


def test_cli_outputs_on_disk(both_runs):
    out = both_runs["root"] / "port_out"
    names = sorted(os.listdir(out))
    assert {"checkpoint-0", "checkpoint-1", "log.txt", "screen.txt", "tb"} <= set(names)
    assert ("checkpoint-best" in names) == (both_runs["tlog"][-1]["max_accuracy"] > 0)
    for epoch in (0, 1):
        with open(out / f"checkpoint-{epoch}" / "meta.json") as f:
            assert json.load(f) == {"step": 4 * (epoch + 1), "extra": {"epoch": epoch}}
    screen = (out / "screen.txt").read_text()
    assert "train: 32 imgs, 4 steps/epoch" in screen and "Epoch: [1] [3/4]" in screen
    assert "torch checkpoint requested: using exact (erf) GELU" in screen
    assert "images, Acc" in screen and "max accuracy:" in screen


def test_a_port_checkpoint_reads_into_dig_tpu_with_the_same_ids(both_runs, data):
    """The port's fine-tuned `checkpoint-1/checkpoint.pth` as the JAX
    package's `--finetune`: the same greedy ids on the eval images."""
    from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
    from dig_tpu.ops import activations as jact
    from dig_tpu.utils.checkpoint import convert_torch_recognizer, load_torch_checkpoint
    from dig_tpu.utils.checkpoint import merge_pretrained_tree as j_merge

    path = str(both_runs["root"] / "port_out" / "checkpoint-1" / "checkpoint.pth")
    jm = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                   jnp.zeros((2, 25), jnp.int32), jnp.ones((2,), jnp.int32), True)["params"]
    params = j_merge(init, convert_torch_recognizer(load_torch_checkpoint(path)))
    images = np.random.default_rng(3).integers(0, 256, (8, 32, 128, 3), dtype=np.uint8)
    x = (images.astype(np.float32) / 255.0 - 0.5) / 0.5
    exact = jact.EXACT
    jact.set_exact(True)
    try:
        _, jids = jm.apply({"params": params}, jnp.asarray(x), 0, EOS, method=jm.recognize)
    finally:
        jact.set_exact(exact)
    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    cfg = parse_config(FinetuneConfig, MODEL + ["--finetune", path])
    assert tcli.load_finetune_init(cfg, model) == len(model.state_dict())
    tact.set_exact(True)
    _, tids = model.recognize(torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


# ---------------------------------------------------------------------------
# the --eval sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0, 2], ids=["greedy", "beam2"])
def sweeps(request, data, tmp_path_factory):
    """`--eval` over two LMDBs with both CLIs; greedy, then beam width 2."""
    root = tmp_path_factory.mktemp(f"sweep{request.param}")
    argv = MODEL + ["--eval", "--finetune", data["pth"], "--eval_data_path", data["eval"],
                    "--other_test_data_folders", data["eval2"], "--dtype", "float32",
                    "--num_workers", "1", "--beam_width", str(request.param)]
    n_dev = jax.device_count()
    with pytest.MonkeyPatch.context() as mp:
        _decoders_at_dropout_0(mp)
        _run_jax(argv + ["--batch_size", str(GLOBAL_BATCH // n_dev), "--output_dir",
                         str(root / "jax")])
    tcli.main(parse_config(FinetuneConfig, argv + ["--batch_size", str(GLOBAL_BATCH),
                                                   "--output_dir", str(root / "port")]),
              device="cpu")
    load = lambda d: json.loads((root / d / "eval_results.json").read_text())
    return request.param, load("jax"), load("port"), (root / "port" / "screen.txt").read_text()


def test_eval_sweep_matches_jax(sweeps, data):
    beam, jres, tres = sweeps[:3]
    assert sorted(tres) == sorted(jres) and tres["beam_width"] == jres["beam_width"] == beam
    assert [r["path"] for r in tres["benchmarks"]] == [data["eval"], data["eval2"]]
    assert [r["n"] for r in tres["benchmarks"]] == [N_EVAL, N_EVAL2] == \
        [r["n"] for r in jres["benchmarks"]]
    for t, j in zip(tres["benchmarks"], jres["benchmarks"]):
        assert t["acc"] == j["acc"]
        assert t["fmeasure"] == pytest.approx(j["fmeasure"], abs=1e-12)
    assert tres["n_images"] == N_EVAL + N_EVAL2
    assert tres["average_acc"] == pytest.approx(jres["average_acc"], abs=1e-12)
    if beam == 0:  # the greedy reading of half the set is its label
        assert tres["benchmarks"][0]["acc"] == (N_EVAL // 2) / N_EVAL


def test_eval_sweep_prints_the_jax_lines(sweeps, data):
    beam, _, tres, screen = sweeps
    assert f"* {data['eval']}: {N_EVAL} images, Acc" in screen
    assert ("loss n/a" in screen) == (beam > 0)
    assert f"average word accuracy over 2 benchmarks: {tres['average_acc']:.4f}" in screen


# ---------------------------------------------------------------------------
# gradient accumulation against optax MultiSteps
# ---------------------------------------------------------------------------

def test_update_freq_matches_optax_multisteps():
    """k = 2 from the same parameters and gradients (4 micro-steps, layer
    decay, a frozen block, clipping): parameters after 1 and 2 applied
    updates within 1e-5; AdamW's step counts applied updates only."""
    from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
    from dig_tpu.optim import create_optimizer as j_create_optimizer
    from dig_tpu.optim import frozen_encoder_mask as j_frozen

    from dig_tpu_torch.optim import frozen_encoder_mask

    jm = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)), jnp.zeros((2, 25), jnp.int32),
        jnp.ones((2,), jnp.int32), True)["params"])
    lr, wd = np.array([1e-3, 5e-4, 2e-4], np.float32), np.array([0.05, 0.04, 0.03], np.float32)
    tx = optax.MultiSteps(j_create_optimizer(
        "adamw", lr, wd, eps=1e-3, clip_grad=0.5, layer_decay=0.75, num_layers=2,
        frozen=j_frozen(1)), every_k_schedule=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)

    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    model.load_state_dict(params_from_jax(params))
    opt = create_optimizer("adamw", model.named_parameters(), lr, wd, eps=1e-3, clip_grad=0.5,
                           layer_decay=0.75, num_layers=2, frozen=frozen_encoder_mask(1),
                           update_freq=2)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(9)
    for micro in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=np.shape(p)).astype(np.float32) * 0.1, params)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in params_from_jax(grads).items():
            named[name].grad = g.clone()
        applied = opt.step()
        assert applied == (micro % 2 == 1) and opt.count == (micro + 1) // 2
        if applied:
            want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
            for name, w in want.items():
                err = float((named[name].detach() - w).abs().max())
                assert err <= 1e-5, f"after update {opt.count}, {name}: {err:.3e}"
    steps = {int(s["step"]) for s in opt.inner.state_dict()["state"].values()}
    assert steps == {2}


def test_update_freq_cli_counts_applied_updates(data, tmp_path):
    """`--update_freq 2`: 4 micro-steps an epoch, 2 updates; the schedule
    spans the updates (steps/epoch printed as the JAX CLI prints it)."""
    cfg = _port_cfg(data, tmp_path / "out", "--update_freq", "2", "--epochs", "1")
    state = tcli.main(cfg, device="cpu")
    assert state.step == 4 and state.optimizer.count == 2 and state.optimizer.mini_step == 0
    screen = (tmp_path / "out" / "screen.txt").read_text()
    assert "train: 32 imgs, 2 steps/epoch" in screen


# ---------------------------------------------------------------------------
# the --finetune sources
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pretrain_ckpt(tmp_path_factory):
    """A port pre-training checkpoint of the micro encoder, its momentum
    branch moved off the student."""
    root = tmp_path_factory.mktemp("pre")
    model = build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128", seed=4,
                                 device="cpu", mlp_dim=32, dim=16, num_windows=4)
    with torch.no_grad():
        for p in model.parameters():
            if not p.requires_grad:
                p.mul_(0.5)
    opt = create_optimizer("adamw", model.named_parameters(), [1e-3])
    path = ckpt.save_checkpoint(str(root), 0, TrainState(model=model, optimizer=opt),
                                extra={"epoch": 0})
    return path, {k: v.clone() for k, v in model.state_dict().items()}


def _encoder_equal_to(model, sd, prefix):
    own = model.state_dict()
    names = [k for k in own if k.startswith("encoder.")]
    assert names
    for k in names:
        assert torch.equal(own[k], sd[prefix + k[len("encoder."):]]), k
    return len(names)


@pytest.mark.parametrize("source", ["directory", "pth", "backbone_pth", "recognizer_pth"])
def test_finetune_sources(source, pretrain_ckpt, data, tmp_path):
    """Each source's encoder tensors equal the file's bit for bit; the
    momentum encoder is never taken; only a recognizer `.pth` brings the
    decoder; a `.pth` means erf GELU, a directory tanh."""
    path, sd = pretrain_ckpt
    if source == "directory":
        arg, prefix = path, "encoder."
    elif source == "pth":
        arg, prefix = os.path.join(path, "checkpoint.pth"), "encoder."
    elif source == "backbone_pth":  # a reference SSL file with the backbone. layout
        arg, prefix = str(tmp_path / "ssl.pth"), "encoder."
        torch.save({"model": {k.replace("encoder.", "backbone.", 1): v for k, v in sd.items()
                              if k.startswith("encoder.")}}, arg)
    else:
        arg, prefix = data["pth"], "encoder."
        sd = ckpt.load_torch_checkpoint(arg)
    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=11, device="cpu")
    decoder_before = {k: v.clone() for k, v in model.state_dict().items()
                      if k.startswith("decoder.")}
    cfg = parse_config(FinetuneConfig, MODEL + ["--finetune", arg])
    n = tcli.load_finetune_init(cfg, model)
    n_enc = _encoder_equal_to(model, sd, prefix)
    own = model.state_dict()
    if source == "recognizer_pth":
        assert n == len(own)
        assert all(torch.equal(own[k], sd[k]) for k in own)
    else:
        assert n == n_enc
        assert all(torch.equal(own[k], v) for k, v in decoder_before.items())
        momentum = sd.get("momentum_encoder.blocks.0.attn.qkv.weight")
        if momentum is not None:
            assert not torch.equal(own["encoder.blocks.0.attn.qkv.weight"], momentum)
    assert tact.resolve_exact_gelu(None, (arg,)) == (source != "directory")


def test_finetune_source_of_another_architecture_raises(tmp_path):
    small = build_rec_model("vit_small_patch4_32x128", "tf_decoder", device="cpu")
    torch.save({"model": small.state_dict()}, tmp_path / "small.pth")
    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    cfg = parse_config(FinetuneConfig, MODEL + ["--finetune", str(tmp_path / "small.pth")])
    with pytest.raises(ValueError, match="matched nothing"):
        tcli.load_finetune_init(cfg, model)


def test_finetune_from_the_pretrain_directory_runs_under_tanh(pretrain_ckpt, data, tmp_path):
    path, sd = pretrain_ckpt
    seen = []
    real = tcli.make_finetune_step

    def spy(model, smoothing):
        step = real(model, smoothing)
        return lambda *a: seen.append(tact.EXACT) or step(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "make_finetune_step", spy)
        state = tcli.main(parse_config(FinetuneConfig, MODEL + RECIPE + [
            "--data_path", data["train"], "--finetune", path, "--epochs", "1", "--batch_size",
            "8", "--output_dir", str(tmp_path / "out")]), device="cpu")
    assert seen == [False] * 4 and state.step == 4
    assert "using exact (erf) GELU" not in (tmp_path / "out" / "screen.txt").read_text()


# ---------------------------------------------------------------------------
# preemption, the trace window, --device_abi_aug, refusals
# ---------------------------------------------------------------------------

def test_sigterm_checkpoints_exits_0_and_resumes(data, tmp_path):
    """SIGTERM to this process during step 1 of epoch 0: a checkpoint at
    the step boundary, exit 0; the next `main` auto-resumes it and redoes
    the epoch from the mid-epoch state."""
    calls = []
    real = tcli.make_finetune_step

    def killer(model, smoothing):
        step = real(model, smoothing)

        def run(*a):
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*a)
        return run

    out = tmp_path / "out"
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "make_finetune_step", killer)
        with pytest.raises(SystemExit) as exit_info:
            tcli.main(_port_cfg(data, out), device="cpu")
    assert exit_info.value.code == 0 and len(calls) == 2
    assert signal.getsignal(signal.SIGTERM) is handler  # the guard is gone again
    payload = ckpt.restore_checkpoint(str(out / "checkpoint-0"))
    assert payload["step"] == 2 and payload["extra"] == {"epoch": -1}
    state = tcli.main(_port_cfg(data, out), device="cpu")
    assert state.step == 2 + 8
    assert "auto-resumed from" in (out / "screen.txt").read_text()


def test_profile_steps_writes_a_trace(data, tmp_path):
    out = tmp_path / "out"
    tcli.main(_port_cfg(data, out, "--epochs", "1", "--profile_steps", "2",
                        "--profile_start_step", "1"), device="cpu")
    with open(out / "profile" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert "[profile] trace of steps [1, 3)" in (out / "screen.txt").read_text()


def test_device_abi_aug_resume_equals_the_straight_run(data, tmp_path):
    """`--device_abi_aug --update_freq 2`, dropout on: a function of (seed,
    micro-step), so two epochs straight equal one epoch + auto-resume + one
    epoch, bit for bit."""
    extra = ("--device_abi_aug", "--update_freq", "2", "--drop", "0.1", "--drop_path", "0.1",
             "--eval_data_path", "")
    recipe = [a for a in RECIPE if a != "--no_use_abi_aug"]
    cfg = lambda out: _port_cfg(data, out, *extra, recipe=recipe)
    assert cfg(tmp_path).use_abi_aug and cfg(tmp_path).device_abi_aug
    straight = tcli.main(cfg(tmp_path / "a"), device="cpu")

    class Stop(Exception):
        pass

    real = tcli.JsonlLogger.write

    def write(self, **stats):
        real(self, **stats)
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli.JsonlLogger, "write", write)
        with pytest.raises(Stop):
            tcli.main(cfg(tmp_path / "b"), device="cpu")
    resumed = tcli.main(cfg(tmp_path / "b"), device="cpu")
    assert resumed.step == straight.step == 8 and resumed.optimizer.count == 4
    sa, sb = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa = straight.optimizer.inner.state_dict()["state"]
    ob = resumed.optimizer.inner.state_dict()["state"]
    assert all(torch.equal(oa[i][n], ob[i][n]) for i in oa for n in oa[i])
    assert _log(tmp_path / "a") == _log(tmp_path / "b")
    assert all(np.isfinite(l["train_loss"]) for l in _log(tmp_path / "a"))


# every model kind, distillation and --text_cond_vis train
# (test_torch_port_kinds_*cli.py); what stays refused about them is what
# dig_tpu refuses too, or a name it does not have
REFUSALS = {
    "model_kind": (["--model_kind", "ctc_beam"], ValueError, "ctc_beam"),
    "distill": (["--use_feat_distill"], ValueError, "teacher_ckpt"),
    "distill_kind": (["--use_feat_distill", "--teacher_ckpt", "t", "--model_kind", "ctc"],
                     ValueError, "requires --model_kind rec"),
    "opt": (["--opt", "lamb_x"], ValueError, "Invalid optimizer 'lamb_x'"),  # as dig_tpu
    # a mesh the world (one process here) does not divide, as dig_tpu's assert
    "n_fsdp": (["--n_fsdp", "2"], ValueError, r"mesh \?x2x1 does not divide 1 devices"),
    "n_tensor": (["--n_tensor", "2"], ValueError, r"mesh \?x1x2 does not divide 1 devices"),
    "resume_pth": (["--resume", "x.pth"], ValueError, "--finetune"),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_cli_refuses_what_is_not_ported(what, data, tmp_path):
    argv, exc, word = REFUSALS[what]
    with pytest.raises(exc, match=word):
        tcli.main(_port_cfg(data, tmp_path / "out", *argv), device="cpu")
    assert not os.path.exists(tmp_path / "out")  # refused before anything is written


SHARDED = {"n_fsdp": ["--n_fsdp", "2"], "n_tensor": ["--n_tensor", "2", "--dist_eval"]}


@pytest.mark.parametrize("what", sorted(SHARDED))
def test_cli_shards_on_two_gloo_ranks(what, data, tmp_path):
    """`--n_fsdp 2` / `--n_tensor 2` under torchrun on two gloo ranks on
    the CPU (tests/_torch_port_ranks.py): an epoch of 2 steps at 2 x 4 rows and
    its eval pass (the sharded parameters gathered, every layer whole;
    under `--dist_eval` each data-parallel rank scores its share).  The
    eval's accuracy and loss are one process's `--eval` of the checkpoint
    the run wrote, to the 4 decimals the line prints."""
    import _torch_port_ranks as launch

    out = tmp_path / "out"
    argv = MODEL + RECIPE + [
        "--data_path", data["train"], "--eval_data_path", data["eval"], "--finetune",
        data["pth"], "--batch_size", "4", "--epochs", "1", "--output_dir", str(out),
        *SHARDED[what]]
    torch.save({"runs": [("finetune", argv)]}, tmp_path / "inputs.pt")
    ranks = launch.torchrun("cli", tmp_path, 2)
    assert [r["steps"] for r in ranks] == [[N_TRAIN // GLOBAL_BATCH]] * 2
    screen = (out / "screen.txt").read_text()
    fsdp, tensor = (2, 1) if what == "n_fsdp" else (1, 2)
    assert f"mesh: {{'data': 1, 'fsdp': {fsdp}, 'tensor': {tensor}}}" in screen
    line = [x for x in screen.splitlines() if x.startswith(f"* {data['eval']}:")][-1]
    one = tmp_path / "one"
    results = tcli.main(_port_cfg(data, one, "--eval", "--resume", str(out / "checkpoint-0"),
                                  "--finetune", "", "--exact_gelu", "true"), device="cpu")
    assert results[0]["n"] == N_EVAL
    assert results[0]["acc"] == _log(out)[-1]["val_acc"]
    want = [x for x in (one / "screen.txt").read_text().splitlines()
            if x.startswith(f"* {data['eval']}:")][-1]
    assert line == want


def test_cli_refuses_dist_eval_across_processes(data, tmp_path, monkeypatch):
    """`--dist_eval` across processes runs (tests/test_torch_port_dist.py);
    what is refused is a launch across processes without a rendezvous: the
    launcher's rank and world size with no MASTER_ADDR / MASTER_PORT fail
    before anything is written, instead of one rank evaluating its share
    alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tcli.main(_port_cfg(data, tmp_path / "out", "--dist_eval"), device="cpu")
    assert not os.path.exists(tmp_path / "out")


def _memory_copy(local_dir, url):
    """A local checkpoint directory copied onto fsspec's in-memory filesystem."""
    import fsspec

    fs, root = fsspec.core.url_to_fs(url)
    for name in os.listdir(local_dir):
        with open(os.path.join(local_dir, name), "rb") as f, fs.open(f"{root}/{name}", "wb") as g:
            g.write(f.read())
    return url


def _params_close(got, want, rtol):
    """Every leaf within `rtol` of its largest value, plus a floor of 1e-6
    of the largest parameter (as `test_cli_final_parameters_match_jax`)."""
    assert sorted(want) == sorted(got)
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err, scale = float((got[name] - w).abs().max()), float(w.abs().max())
        assert err <= rtol * scale + floor, f"{name}: {err:.3e} vs max {scale:.3e}"


@pytest.mark.parametrize("what", ["opt", "teacher_remote", "resume_remote"])
def test_cli_runs_the_options_dig_tpu_runs(what, both_runs, data, tmp_path):
    """What the port once refused:
    * opt: both CLIs with `--opt adamp` (the projection and its wd_ratio)
      from the same `.pth`: the logs' losses within 1e-4 and every final
      leaf within 1e-4 of its largest value, as AdamW's runs above;
    * teacher_remote: distillation from a teacher on fsspec's in-memory
      filesystem (a copy of `both_runs`' port checkpoint) repeats the run
      from the local directory bit for bit (one epoch);
    * resume_remote: `--resume memory://...` of `both_runs`' port
      checkpoint-0 repeats the `--resume` of the local directory bit for
      bit."""
    if what == "opt":
        n_dev = jax.device_count()
        with pytest.MonkeyPatch.context() as mp:
            _decoders_at_dropout_0(mp)
            jfinal = _run_jax(MODEL + RECIPE + [
                "--data_path", data["train"], "--eval_data_path", data["eval"],
                "--finetune", data["pth"], "--batch_size", str(GLOBAL_BATCH // n_dev),
                "--output_dir", str(tmp_path / "jax_out"), "--opt", "adamp"])
        tfinal = tcli.main(_port_cfg(data, tmp_path / "port_out", "--opt", "adamp"),
                           device="cpu")
        assert tfinal.optimizer.rule == "adamp" and tfinal.optimizer.count == 8
        for jl, tl in zip(_log(tmp_path / "jax_out"), _log(tmp_path / "port_out")):
            np.testing.assert_allclose(tl["train_loss"], jl["train_loss"], rtol=1e-4)
        _params_close(tfinal.model.state_dict(),
                      params_from_jax(jax.tree_util.tree_map(np.asarray, jfinal.params)), 1e-4)
        return
    local = str(both_runs["root"] / "port_out" / ("checkpoint-1" if what == "teacher_remote"
                                                  else "checkpoint-0"))
    url = _memory_copy(local, f"memory://ft-cli-{what}-{os.getpid()}/ckpt")
    flag = (["--use_feat_distill", "--teacher_ckpt"] if what == "teacher_remote"
            else ["--resume"])
    runs = [tcli.main(_port_cfg(data, tmp_path / name, *flag, path, "--epochs", "1"
                                if what == "teacher_remote" else "2", "--eval_data_path", ""),
                      device="cpu") for name, path in (("local", local), ("remote", url))]
    a, b = (r.model.state_dict() for r in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert _log(tmp_path / "local") == _log(tmp_path / "remote")
    assert runs[0].step == (4 if what == "teacher_remote" else 8)


def test_cli_reads_a_native_dig_tpu_directory(both_runs, data, tmp_path):
    """The JAX CLI's own ``checkpoint-1`` (a native directory, read without
    JAX) as `--finetune` (the encoder, equal to `dig_tpu`'s final encoder
    bit for bit), as `--resume` of an `--eval` run (the whole recognizer:
    the same accuracy as `dig_tpu`'s last eval of it) and as
    `--teacher_ckpt` (one epoch of distillation, finite)."""
    native = str(both_runs["root"] / "jax_out" / "checkpoint-1")
    assert os.path.exists(os.path.join(native, "arrays.npz"))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, both_runs["jfinal"].params))
    cfg = _port_cfg(data, tmp_path / "init", "--finetune", native)
    model = tcli.build_model(cfg, "cpu")
    assert tcli.load_finetune_init(cfg, model) == sum(k.startswith("encoder.") for k in want)
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want if k.startswith("encoder."))
    res = tcli.main(_port_cfg(data, tmp_path / "eval", "--eval", "--resume", native,
                              "--finetune", ""), device="cpu")
    assert res[0]["acc"] == both_runs["jlog"][-1]["val_acc"]
    run = tcli.main(_port_cfg(data, tmp_path / "distill", "--use_feat_distill",
                              "--teacher_ckpt", native, "--epochs", "1", "--eval_data_path", ""),
                    device="cpu")
    assert run.step == 4 and all(np.isfinite(l["train_loss"]) for l in _log(tmp_path / "distill"))


def test_cli_needs_a_card_unless_asked_for_the_cpu(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no card is visible"):
        tcli.main(_port_cfg(data, tmp_path / "out"))
