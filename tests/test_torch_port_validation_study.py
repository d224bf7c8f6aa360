"""The port's validation study runner (`dig_tpu_torch.tools.validation_study`)
against `tools/validation_study.sh` and `tools/rerun_ssl_low_arm.sh`, on the CPU.

The scripts run unedited with a stub `python` first on PATH that records
its argv and makes the `checkpoint-N` directories and `screen.txt` lines
the scripts list and grep; the runner's plan for the same knobs must be
those commands, with `dig_tpu.` as `dig_tpu_torch.` and `tools/gen_synth.py`
as `-m dig_tpu_torch.tools.gen_synth`.  Every flag of every plan parses in
the port's CLIs.  Then the runner runs every stage at the micro width on
the CPU (corpora of a few dozen images, one epoch each), and a second call
runs nothing.  Asked for CUDA without a card, it raises."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_port_threads import one_thread

from dig_tpu_torch.tools import validation_study as vs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = """#!{exe}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["STUDY_STUB_LOG"], "a") as f:
    f.write(json.dumps(args) + "\\n")
flag = lambda name, default=None: args[args.index(name) + 1] if name in args else default
out = flag("--output_dir")
if "-m" in args and out:
    os.makedirs(out, exist_ok=True)
    cli = args[args.index("-m") + 1]
    last = int(flag("--epochs", "1")) - 1
    if cli.endswith("run_pretrain") or ("--save_ckpt_freq" in args
                                        and "--no_save_ckpt" not in args):
        os.makedirs(os.path.join(out, "checkpoint-%d" % last), exist_ok=True)
    if cli.endswith("run_finetune") and "--eval" not in args:
        with open(os.path.join(out, "screen.txt"), "a") as f:
            f.write("max accuracy: 0.5000\\n")
"""
# each case: the script, its environment, the runner's flags
KNOB_SETS = {
    "defaults": ("validation_study.sh", {}, []),
    "low_label_beam": ("validation_study.sh", {"LOW_LABEL": "3000", "BEAM_WIDTH": "5"}, []),
    "vit_small": ("validation_study.sh",
                  {"PRE_MODEL": "pretrain_simmim_moco_ori_vit_small_patch4_32x128",
                   "FT_MODEL": "vit_small_patch4_32x128", "FT_LR": "2e-4"}, []),
    "ssl_low": ("rerun_ssl_low_arm.sh", {}, ["--preset", "ssl_low"]),
}


def as_port(argv):
    """A recorded command of the JAX scripts in the port's spelling."""
    out = []
    for a in argv:
        if a == "tools/gen_synth.py":
            out += ["-m", "dig_tpu_torch.tools.gen_synth"]
        else:
            out.append("dig_tpu_torch." + a[len("dig_tpu."):] if a.startswith("dig_tpu.") else a)
    return out


def runner_plan(workdir, env, flags):
    args, knobs = vs.parse_args([str(workdir), *flags] + [
        x for k, v in env.items() for x in (f"--{k.lower()}", v)])
    return vs.plan(os.path.abspath(args.workdir), knobs, args.preset)


def script_commands(tmp_path, script, env):
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    (stub_dir / "python").write_text(STUB.format(exe=sys.executable))
    (stub_dir / "python").chmod(0o755)
    log = tmp_path / "argv.jsonl"
    workdir = tmp_path / "study"
    subprocess.run(["bash", os.path.join(ROOT, "tools", script), str(workdir)], check=True,
                   capture_output=True, text=True, timeout=120,
                   env=dict(os.environ, **env, PATH=f"{stub_dir}:{os.environ['PATH']}",
                            STUDY_STUB_LOG=str(log)))
    return workdir, [as_port(json.loads(x)) for x in log.read_text().splitlines()]


@pytest.mark.parametrize("case", sorted(KNOB_SETS))
def test_plan_is_the_scripts_commands(case, tmp_path):
    script, env, flags = KNOB_SETS[case]
    before = [s.argv for s in runner_plan(tmp_path / "study", env, flags)]
    workdir, commands = script_commands(tmp_path, script, env)
    after = [s.argv for s in runner_plan(workdir, env, flags)]
    assert after == commands
    # before a stage has run, the plan names the checkpoint it will write
    assert before == after


@pytest.mark.parametrize("case", sorted(KNOB_SETS))
def test_every_flag_parses(case, tmp_path):
    _, env, flags = KNOB_SETS[case]
    stages = [s for s in runner_plan(tmp_path / "study", env, flags) if s.is_cli]
    assert stages and all(vs.unknown_flags(s) == [] for s in stages)
    vs.check_flags(stages)


def test_an_unknown_flag_fails_before_any_stage(tmp_path, monkeypatch):
    plan = vs.plan

    def with_typo(*a, **kw):
        stages = plan(*a, **kw)
        stages[-1].argv.append("--save_chkpt_freq")
        return stages

    monkeypatch.setattr(vs, "plan", with_typo)
    with pytest.raises(ValueError, match="save_chkpt_freq"):
        vs.run_study(str(tmp_path / "study"), vs.Knobs(), device="cpu")
    assert not os.path.exists(tmp_path / "study" / "logs")


def test_no_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no card"):
        vs.run_study(str(tmp_path / "study"), vs.Knobs())
    assert not os.path.exists(tmp_path / "study")


MICRO = ["--unlabeled", "128", "--labeled", "128", "--test", "32", "--words", "20",
         "--pre_epochs", "1", "--ft_epochs", "1",
         "--pre_model", "pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
         "--ft_model", "vit_micro_patch4_32x128", "--beam_width", "2", "--low_label", "128",
         "--device", "cpu"]
# ft_ssl_low would read a ViT-tiny pre-training checkpoint (the script fixes
# the low-label arms' model); the plan test holds its flags
MICRO_STAGES = ["corpusA", "corpusB", "pretrain", "ft_scratch", "ft_ssl", "eval_greedy",
                "eval_beam", "ft_scratch_low"]


@pytest.fixture(scope="module")
def micro_study(tmp_path_factory):
    """The runner over every stage but ft_ssl_low, on the CPU; TensorBoard
    scalars off in the stages (tensorflow's import alone takes seconds)."""
    tmp = tmp_path_factory.mktemp("study")
    (tmp / "no_tf" / "tensorflow").mkdir(parents=True)
    (tmp / "no_tf" / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('TensorBoard scalars off')\n")
    saved = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(tmp / "no_tf")] + ([saved["PYTHONPATH"]] if saved["PYTHONPATH"] else []))
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        args, knobs = vs.parse_args([str(tmp / "w"), *MICRO])
        res = vs.run_study(args.workdir, knobs, stages=MICRO_STAGES, device="cpu")
        yield tmp / "w", knobs, res
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_micro_study_runs_every_stage(micro_study):
    workdir, _, res = micro_study
    assert sorted(res["stages"]) == sorted(MICRO_STAGES)
    for name, stage in res["stages"].items():
        assert stage["seconds"] > 0
        if not name.startswith("corpus"):
            assert stage["device"] == "cpu", name
    for arm in ("ft_scratch", "ft_ssl", "ft_scratch_low"):
        r = res["arms"][arm]
        assert 0 <= r["best_word_acc"] <= 1 and 0 <= r["best_char_f"] <= 1, arm
        assert len(r["word_acc_by_epoch"]) == 1 and 0 <= r["word_acc_by_epoch"][0] <= 1
    for mode in ("eval_greedy", "eval_beam"):
        assert 0 <= res["arms"][mode]["word_acc"] <= 1
    pre = res["pretrain"]
    assert all(pre[k]["first"] is not None for k in ("loss_contrast", "loss_pixel", "q1_acc1"))
    # the corpora's renderer: OpenCV 4.x and 5.x draw gen_synth's Hershey faces differently
    import cv2

    assert {res["stages"][c].get("opencv") for c in ("corpusA", "corpusB")} == {cv2.__version__}
    with open(workdir / "results.json") as f:
        assert json.load(f)["arms"] == json.loads(json.dumps(res["arms"]))


def test_ssl_arm_starts_from_the_pretrain_encoder(micro_study):
    from dig_tpu_torch.cli.run_finetune import build_model, load_finetune_init
    from dig_tpu_torch.config import FinetuneConfig, parse_config

    workdir, knobs, res = micro_study
    ck = str(workdir / "pre" / "checkpoint-0")
    n, path = res["arms"]["ft_ssl"]["init"]
    assert path == ck and int(n) > 0
    assert res["arms"]["ft_scratch"]["init"] is None
    stage = next(s for s in vs.plan(str(workdir), knobs) if s.name == "ft_ssl")
    cfg = parse_config(FinetuneConfig, stage.argv[2:])
    model = build_model(cfg, "cpu")
    assert load_finetune_init(cfg, model) == int(n)
    saved = torch.load(os.path.join(ck, "checkpoint.pth"), map_location="cpu",
                       weights_only=True)["model"]
    got = model.state_dict()
    same = [k for k in got if k.startswith("encoder.") and k in saved
            and saved[k].shape == got[k].shape]
    assert same and all(torch.equal(got[k], saved[k].to(got[k].dtype)) for k in same)


def test_a_second_call_skips_finished_stages(micro_study, capsys):
    workdir, knobs, res = micro_study
    stamps = {p: os.stat(workdir / "stages" / p).st_mtime_ns
              for p in os.listdir(workdir / "stages")}
    again = vs.run_study(str(workdir), knobs, stages=MICRO_STAGES, device="cpu")
    assert {p: os.stat(workdir / "stages" / p).st_mtime_ns
            for p in os.listdir(workdir / "stages")} == stamps
    assert again["arms"] == res["arms"] and again["stages"] == res["stages"]
    out = capsys.readouterr().out
    assert "ended in" not in out and "=== results (best test word accuracy per arm) ===" in out


def test_carried_files_resume_the_study(micro_study, tmp_path):
    workdir, knobs, _ = micro_study
    carried = tmp_path / "w"
    vs.carry(str(workdir), str(carried))
    stages = vs.plan(str(carried), knobs)
    # the corpora are made again where a stage needs them; the slim checkpoint serves
    assert [s.name for s in vs.to_run(stages, ["ft_ssl_low"], str(carried))] == \
        ["corpusB", "ft_ssl_low"]
    assert vs.to_run(stages, MICRO_STAGES, str(carried)) == []
    shutil.rmtree(carried / "pre" / "checkpoint-0")
    assert [s.name for s in vs.to_run(vs.plan(str(carried), knobs), ["ft_ssl_low"],
                                      str(carried))] == \
        ["corpusA", "corpusB", "pretrain", "ft_ssl_low"]


def _probe_tool():
    """tools/encoder_ctc_probe.py, the study's probe of a frozen encoder."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "encoder_ctc_probe", os.path.join(ROOT, "tools", "encoder_ctc_probe.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("init", ["random", "pretrain"])
def test_encoder_probe_reads_the_study_corpora(init, micro_study):
    """The linear CTC probe over a random encoder and over the micro study's
    pre-training checkpoint: finite losses, an accuracy in [0, 1], every
    image of both sets; the checkpoint's encoder gives other features."""
    workdir, _, _ = micro_study
    probe = _probe_tool().probe
    args = (str(workdir / "corpusB" / "labeled"), str(workdir / "corpusB" / "test"))
    kw = dict(model="vit_micro_patch4_32x128", epochs=2, device="cpu")
    got = probe(*args, checkpoint=str(workdir / "pre" / "checkpoint-0")
                if init == "pretrain" else "", **kw)
    assert (got["n_train"], got["n_test"]) == (128, 32)
    assert all(np.isfinite(got[k]) and got[k] > 0 for k in ("train_ctc_loss", "test_ctc_loss"))
    assert 0 <= got["test_word_acc"] <= 1
    if init == "pretrain":
        assert got["train_ctc_loss"] != probe(*args, **kw)["train_ctc_loss"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no card"):
                probe(*args, model="vit_micro_patch4_32x128", epochs=1)


def test_ssl_swap_runs_end_to_end(tmp_path):
    """tests/_torch_port_ssl_swap.py, the encoder x fine-tuner swap across the
    two packages, at its smallest size (16 unlabeled, 16 labeled, 8 test
    images, batch 8, one pre-training epoch and one epoch an arm, each stage
    on one thread): every arm ends with one epoch's accuracy, and each SSL
    arm's `--finetune` copied every tensor of the encoder it names that the
    recognizer has (the counts both CLIs print), the scratch arms none."""
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.utils.checkpoint import restore_checkpoint

    # dig_tpu's flax init compiles a few hundred small programs eagerly: the
    # cache keeps them all, as it keeps the steps
    env = dict(os.environ, OMP_NUM_THREADS="1", XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
               JAX_COMPILATION_CACHE_DIR=os.path.join(ROOT, "tests", ".jax_cache"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    w = tmp_path / "swap"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_ssl_swap.py"), str(w),
         "--unlabeled", "16", "--labeled", "16", "--test", "8", "--words", "4",
         "--pre_epochs", "1", "--warmup_steps", "1", "--ft_epochs", "1", "--batch_size", "8",
         "--moco_mlp_dim", "32", "--moco_dim", "16"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    enc = [k for k in restore_checkpoint(str(w / "pre_port" / "checkpoint-0"))["model"]
           if k.startswith("encoder.")]
    rec = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    n_enc = len(set(enc) & set(rec.state_dict()))
    assert n_enc == 28  # the patch embedding and 2 blocks of 13; not the mask token
    sources = {"jax": str(w / "pre_jax" / "checkpoint-0"), "port": str(w / "enc_port.pth")}
    assert sorted(res["arms"]) == sorted(
        [f"ssl_{e}_{f}_s0" for e in ("jax", "port") for f in ("jax", "port")]
        + ["scratch_jax_s0", "scratch_port_s0"])
    for name, arm in res["arms"].items():
        assert len(arm["word_acc"]) == 1 and 0 <= arm["word_acc"][0] <= 1, name
        if name.startswith("ssl_"):
            assert (arm["init_tensors"], arm["init_from"]) == (n_enc, sources[name.split("_")[1]])
        else:
            assert arm["init_tensors"] is None, name

