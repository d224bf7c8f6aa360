"""The SSL-transfer validation study on the port's CLIs: `tools/validation_study.sh`
and `tools/rerun_ssl_low_arm.sh` as one resumable runner, without JAX.

Does DiG-style self-supervised pre-training (MoCo + MIM) carry over to
recognition, measured by word accuracy on a held-out test set?  The
protocol, the seeds, the corpora and every stage's flags are the scripts':

    corpusA      unlabeled rendered words (gen_synth --easy, seed 3)
    corpusB      labeled + test split on a small shared word pool (seed 5)
    pretrain     run_pretrain, MoCo + MIM on corpus A, --device_aug
    ft_scratch   run_finetune from scratch on corpus B
    ft_ssl       the same recipe, --finetune <newest pretrain checkpoint>
    eval_greedy, eval_beam          with --beam_width: both decoders on the
                                    SSL arm's final checkpoint
    ft_scratch_low, ft_ssl_low      with --low_label N: both arms on N labels
                                    at the 12k arms' step budget

    python -m dig_tpu_torch.tools.validation_study WORKDIR [--unlabeled 40000]
        [--pre_epochs 12] [--labeled 8000] [--test 3000] [--words 300]
        [--ft_epochs 60] [--pre_model ...] [--ft_model ...] [--decoder ...]
        [--ft_lr 8e-4] [--beam_width 5] [--low_label 3000]
        [--preset ssl_low] [--stages pretrain,ft_ssl] [--device cuda]

The knobs are the script's environment variables in lower case, with its
defaults.  `--preset ssl_low` is `tools/rerun_ssl_low_arm.sh`: the round-4
corpora (120,000 unlabeled, 15 pre-training epochs; 12,000 / 3,000 labels
and tests over 400 words) and the 3,000-label SSL arm alone (240 epochs,
warm-up 8).  `--stages` runs the named stages and the missing stages they
need; by default every stage of the plan runs.

Each stage runs in a process of its own, as the script runs it, with its log
in WORKDIR/logs/<stage>.log; the training CLIs run on the card (`--device
cpu` runs them on the CPU, for the tests) and report their kernels' launch
counts.  A stage that ends writes WORKDIR/stages/<stage>.json (its argv,
wall seconds, device, launches); a later call skips it while its argv is
the same, and reruns a stage it needs whose products are gone (a corpus, the
pre-training checkpoint), so the study can be spread over several calls by
copying back the small files.  A stage that did not end is run again from
its start: the runner differs from the scripts only in how it runs and
resumes stages, never in a stage's flags.  Before any stage runs, every
training stage's flags are parsed, and a flag the port's CLIs do not know
is an error (their `parse_config` only warns), as is such a warning in a
stage's log.  Every process a stage started must be gone when it ends.

At the end the script's "=== results ===" block is printed and
WORKDIR/results.json written: each arm's best test word accuracy (the
CLI's `max accuracy:` line), best char F-measure, word accuracy at each
epoch (from its log.txt), the pre-training losses, each stage's seconds,
the card's name and power limit, and the OpenCV build that rendered each
corpus: `gen_synth` draws its words with OpenCV's Hershey faces, which
OpenCV 4.13 and 5.0 draw as different glyphs, so accuracies compare only
between corpora rendered by the same OpenCV.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import importlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
UNKNOWN_FLAGS = "[config] ignoring unknown flags"
LAUNCHES_PREFIX = "validation_study: launches "
GEN_SYNTH = ["-m", "dig_tpu_torch.tools.gen_synth"]
PRETRAIN = ["-m", "dig_tpu_torch.cli.run_pretrain"]
FINETUNE = ["-m", "dig_tpu_torch.cli.run_finetune"]
CONFIGS = {"dig_tpu_torch.cli.run_pretrain": "PretrainConfig",
           "dig_tpu_torch.cli.run_finetune": "FinetuneConfig"}


@dataclasses.dataclass
class Knobs:
    unlabeled: int = 40000
    pre_epochs: int = 12
    labeled: int = 8000
    test: int = 3000
    words: int = 300
    ft_epochs: int = 60
    pre_model: str = "pretrain_simmim_moco_ori_vit_tiny_patch4_32x128"
    ft_model: str = "vit_tiny_patch4_32x128"
    decoder: str = "small_tf_decoder"
    ft_lr: str = "8e-4"  # passed on as written, as the script does
    beam_width: str = ""
    low_label: str = ""


# tools/rerun_ssl_low_arm.sh: its knobs, its stages and its pretrain time limit
PRESETS = {"ssl_low": dict(knobs=dict(unlabeled=120000, pre_epochs=15, labeled=12000, test=3000,
                                      words=400, ft_epochs=60, low_label="3000"),
                           stages=("corpusA", "corpusB", "pretrain", "ft_ssl_low"),
                           timeouts=dict(pretrain=7200))}


@dataclasses.dataclass
class Stage:
    name: str
    argv: list  # the interpreter's arguments, as the script runs the stage
    out: str  # the directory the stage writes
    needs: tuple = ()  # stages whose products this one reads
    timeout: float = None  # seconds, the script's `timeout`

    @property
    def is_cli(self):
        return self.argv[1] in CONFIGS


def newest_checkpoint(out_dir, epochs):
    """The script's `ls | grep -E '^checkpoint-[0-9]+$' | sort -n | tail -1`,
    or, before the stage has run, the one its last epoch writes."""
    found = [n for n in (os.listdir(out_dir) if os.path.isdir(out_dir) else [])
             if re.fullmatch(r"checkpoint-[0-9]+", n)]
    name = (max(found, key=lambda n: int(n.split("-")[1])) if found
            else f"checkpoint-{int(epochs) - 1}")
    return os.path.join(out_dir, name)


def plan(workdir, knobs: Knobs, preset=None):
    """The stages of `tools/validation_study.sh` for these knobs (or of the
    preset's script), in its order."""
    d, k = workdir.rstrip("/"), knobs
    corpus = ["--easy", "--test_pool", "shared"]
    stages = [
        Stage("corpusA", GEN_SYNTH + [f"{d}/corpusA", *corpus, "--train", str(k.unlabeled),
                                      "--labeled", "100", "--test", "100", "--train_words", "1500",
                                      "--test_words", "10", "--max_word_len", "6", "--seed", "3"],
              f"{d}/corpusA"),
        Stage("corpusB", GEN_SYNTH + [f"{d}/corpusB", *corpus, "--train", "100",
                                      "--labeled", str(k.labeled), "--test", str(k.test),
                                      "--train_words", str(k.words), "--test_words", "10",
                                      "--max_word_len", "6", "--seed", "5"],
              f"{d}/corpusB"),
        Stage("pretrain", PRETRAIN + ["--model", k.pre_model, "--image_alone_path",
                                      f"{d}/corpusA/train", "--batch_size", "128", "--epochs",
                                      str(k.pre_epochs), "--warmup_steps", "300", "--device_aug",
                                      "--num_workers", "8", "--output_dir", f"{d}/pre",
                                      "--save_ckpt_freq", "1000", "--eval_freq", "0"],
              f"{d}/pre", ("corpusA",), 10800),
    ]
    ck = newest_checkpoint(f"{d}/pre", k.pre_epochs)
    data = ["--data_path", f"{d}/corpusB/labeled", "--eval_data_path", f"{d}/corpusB/test"]
    for arm in ("scratch", "ssl"):
        extra = ["--finetune", ck] if arm == "ssl" else []
        save = ["--no_save_ckpt"]
        if arm == "ssl" and k.beam_width:  # the final epoch for the beam pair, one save
            save = ["--no_save_best", "--save_ckpt_freq", "100000"]
        stages.append(Stage(
            f"ft_{arm}", FINETUNE + ["--model", k.ft_model, "--decoder_name", k.decoder, *data,
                                     "--batch_size", "128", "--epochs", str(k.ft_epochs),
                                     "--warmup_epochs", "2", "--num_workers", "8", "--lr",
                                     k.ft_lr, *extra, *save, "--output_dir", f"{d}/ft_{arm}",
                                     "--eval_freq", "0"],
            f"{d}/ft_{arm}", ("corpusB", "pretrain") if extra else ("corpusB",), 14000))
    if k.beam_width:
        final = newest_checkpoint(f"{d}/ft_ssl", k.ft_epochs)
        for mode in ("greedy", "beam"):
            stages.append(Stage(
                f"eval_{mode}", FINETUNE + ["--model", k.ft_model, "--decoder_name", k.decoder,
                                            *data, "--batch_size", "128", "--eval", "--resume",
                                            final, "--beam_width",
                                            k.beam_width if mode == "beam" else "0",
                                            "--num_workers", "8", "--no_save_ckpt",
                                            "--output_dir", f"{d}/eval_{mode}"],
                f"{d}/eval_{mode}", ("corpusB", "ft_ssl"), 3600))
    if k.low_label:
        ll_epochs = int(k.ft_epochs) * int(k.labeled) // int(k.low_label)
        for arm in ("scratch", "ssl"):
            extra = ["--finetune", ck] if arm == "ssl" else []
            stages.append(Stage(
                f"ft_{arm}_low", FINETUNE + [
                    "--model", "vit_tiny_patch4_32x128", "--decoder_name", "small_tf_decoder",
                    *data, "--num_samples", k.low_label, "--batch_size", "128", "--epochs",
                    str(ll_epochs), "--warmup_epochs", str(ll_epochs // 30), "--num_workers",
                    "8", "--lr", k.ft_lr, *extra, "--no_save_ckpt", "--output_dir",
                    f"{d}/ft_{arm}_low", "--save_ckpt_freq", "100000", "--eval_freq", "0"],
                f"{d}/ft_{arm}_low", ("corpusB", "pretrain") if extra else ("corpusB",), 14000))
    if preset:
        p = PRESETS[preset]
        stages = [dataclasses.replace(s, timeout=p["timeouts"].get(s.name, s.timeout))
                  for s in stages if s.name in p["stages"]]
    return stages


def config_class(module):
    from dig_tpu_torch import config

    return getattr(config, CONFIGS[module])


def unknown_flags(stage):
    """The flags of a training stage that its CLI's `parse_config` would
    drop with a warning."""
    from dig_tpu_torch.config import parse_config

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        parse_config(config_class(stage.argv[1]), stage.argv[2:])
    return [line for line in buf.getvalue().splitlines() if line.startswith(UNKNOWN_FLAGS)]


def check_flags(stages):
    bad = {s.name: u for s in stages if s.is_cli and (u := unknown_flags(s))}
    if bad:
        raise ValueError(f"flags the port's CLIs do not know: {bad}")


def products(stage, workdir):
    """The files a stage leaves for the stages after it."""
    if stage.name.startswith("corpus"):
        return [os.path.join(stage.out, s, "data.mdb") for s in ("train", "labeled", "test")]
    if stage.name == "pretrain" or ("--save_ckpt_freq" in stage.argv
                                    and "--no_save_ckpt" not in stage.argv):
        return [os.path.join(newest_checkpoint(stage.out, 1), "checkpoint.pth")]
    return []


def marker_path(workdir, name):
    return os.path.join(workdir, "stages", f"{name}.json")


def portable(argv, workdir):
    """argv with WORKDIR written as "$D", as the record keeps it."""
    return [a.replace(workdir, "$D") for a in argv]


def finished(stage, workdir):
    """The stage ran to its end with these flags."""
    try:
        with open(marker_path(workdir, stage.name)) as f:
            return json.load(f)["argv"] == portable(stage.argv, workdir)
    except (OSError, ValueError, KeyError):
        return False


def to_run(stages, selected, workdir):
    """The selected stages that have not finished, and every stage they
    need whose products are gone or that has not finished."""
    by_name = {s.name: s for s in stages}
    want = set()

    def need(name, for_products):
        s = by_name[name]
        if finished(s, workdir) and (not for_products or
                                     all(os.path.exists(p) for p in products(s, workdir))):
            return
        want.add(name)
        for dep in s.needs:
            need(dep, True)

    for name in selected:
        need(name, False)
    return [s for s in stages if s.name in want]


def session_processes(sid):
    """Processes of session `sid` still alive (Linux /proc)."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            left.append(int(pid))
    return left


def run_stage(stage, workdir, device):
    """One stage in a process (and session) of its own, its output in
    WORKDIR/logs/<stage>.log; returns the marker it writes."""
    if os.path.isdir(stage.out):  # an earlier attempt that did not end
        shutil.rmtree(stage.out)
    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    log_path = os.path.join(workdir, "logs", f"{stage.name}.log")
    argv = ([sys.executable, "-m", "dig_tpu_torch.tools.validation_study", "--stage-child",
             device, *stage.argv[1:]] if stage.is_cli else [sys.executable, *stage.argv])
    print(f"[{stage.name}] {' '.join(stage.argv)}", flush=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=stage.timeout)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            left = session_processes(proc.pid)
            for pid in left:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise RuntimeError(f"stage {stage.name} exited {rc}; its log {log_path} ends:\n"
                           f"{text[-3000:]}")
    if left:
        raise RuntimeError(f"stage {stage.name} left processes running: {left}")
    if UNKNOWN_FLAGS in text:
        raise RuntimeError(f"stage {stage.name}: its CLI dropped flags ({log_path})")
    missing = [p for p in products(stage, workdir) if not os.path.exists(p)]
    if missing:
        raise RuntimeError(f"stage {stage.name} wrote no {missing}")
    devices = re.findall(r"^devices: \d+ \(([^,)]+)", text, re.M)
    launches = [json.loads(x[len(LAUNCHES_PREFIX):]) for x in text.splitlines()
                if x.startswith(LAUNCHES_PREFIX)]
    marker = {"argv": portable(stage.argv, workdir), "seconds": seconds,
              "device": devices[-1] if devices else None,
              "launches": launches[-1] if launches else None}
    if stage.name.startswith("corpus"):
        marker["opencv"] = opencv_version()
    os.makedirs(os.path.join(workdir, "stages"), exist_ok=True)
    with open(marker_path(workdir, stage.name), "w") as f:
        json.dump(marker, f, indent=1)
    print(f"[{stage.name}] ended in {seconds:.1f} s", flush=True)
    return marker


def stage_child(device, argv):
    """`python -m <cli> ARGS` (argv = [cli, *ARGS]) on `device`, then the
    kernels' launch counts."""
    module = importlib.import_module(argv[0])
    from dig_tpu_torch.config import parse_config
    from dig_tpu_torch.ops import launch_counts

    module.main(parse_config(config_class(argv[0]), argv[1:]), device=device)
    print(LAUNCHES_PREFIX + json.dumps(launch_counts()), flush=True)
    return 0


def opencv_version():
    """The OpenCV build `gen_synth` renders with in this environment."""
    import cv2

    return cv2.__version__


def card_name_and_limit():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, or
    None where there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def read(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def arm_result(out):
    screen = read(os.path.join(out, "screen.txt"))
    best = re.findall(r"max accuracy: ([0-9.]+)", screen)
    evals = re.findall(r"^\* .*?: \d+ images, Acc ([0-9.]+) loss \S+ Rec_fmeasure ([0-9.]+)",
                       screen, re.M)
    epochs = [json.loads(x) for x in read(os.path.join(out, "log.txt")).splitlines() if x]
    return {"best_word_acc": float(best[-1]) if best else None,
            "best_char_f": max((float(f) for _, f in evals), default=None),
            "word_acc_by_epoch": [e.get("val_acc") for e in epochs if "epoch" in e],
            "init": (re.findall(r"^\[finetune\] (\d+) tensors initialized from (\S+)", screen,
                                re.M) or [None])[-1]}


def pretrain_result(out):
    """First and last logged step values of the losses and q1 top-1, and
    their average per epoch."""
    screen = read(os.path.join(out, "screen.txt"))
    res = {}
    for key in ("loss_contrast", "loss_pixel", "q1_acc1"):
        vals = [float(v) for v in re.findall(rf"^Epoch: .*?\b{key}: ([-0-9.naif]+) \(",
                                             screen, re.M)]
        res[key] = {"first": vals[0] if vals else None, "last": vals[-1] if vals else None,
                    "by_epoch": [e.get(f"train_{key}") for e in
                                 (json.loads(x) for x in
                                  read(os.path.join(out, "log.txt")).splitlines() if x)]}
    return res


def results(stages, workdir):
    res = {"card": card_name_and_limit(), "stages": {}, "arms": {}}
    for s in stages:
        try:
            with open(marker_path(workdir, s.name)) as f:
                marker = json.load(f)
        except OSError:
            continue
        res["stages"][s.name] = {k: marker[k] for k in ("seconds", "device", "launches",
                                                         "opencv") if k in marker}
        if s.name.startswith("ft_"):
            res["arms"][s.name] = arm_result(s.out)
        elif s.name.startswith("eval_"):
            ev = json.loads(read(os.path.join(s.out, "eval_results.json")) or "{}")
            res["arms"][s.name] = {"word_acc": ev.get("average_acc"), "char_f": (
                ev["benchmarks"][0]["fmeasure"] if ev.get("benchmarks") else None)}
        elif s.name == "pretrain":
            res["pretrain"] = pretrain_result(s.out)
    return res


def carry(workdir, dest):
    """Copy to `dest` what a later call needs to go on with the study from a
    fresh WORKDIR (`cp -r dest/. WORKDIR`): the stage records, the logs,
    each stage's screen.txt, log.txt and eval_results.json, and the newest
    pre-training checkpoint with its student encoder's tensors alone (the
    tensors `--finetune` reads; ViT-tiny's in ~22 MB of the ~400 MB
    checkpoint).  The corpora are not carried: seeded, they are made again."""
    import torch

    for sub in ("stages", "logs"):
        if os.path.isdir(os.path.join(workdir, sub)):
            shutil.copytree(os.path.join(workdir, sub), os.path.join(dest, sub),
                            dirs_exist_ok=True)
    for path in glob.glob(os.path.join(workdir, "*", "*")):
        if os.path.basename(path) in ("screen.txt", "log.txt", "eval_results.json"):
            os.makedirs(os.path.join(dest, os.path.basename(os.path.dirname(path))),
                        exist_ok=True)
            shutil.copy(path, os.path.join(dest, os.path.relpath(path, workdir)))
    if os.path.exists(os.path.join(workdir, "results.json")):
        shutil.copy(os.path.join(workdir, "results.json"), dest)
    ck = newest_checkpoint(os.path.join(workdir, "pre"), 1)
    if os.path.exists(os.path.join(ck, "checkpoint.pth")):
        out = os.path.join(dest, os.path.relpath(ck, workdir))
        os.makedirs(out, exist_ok=True)
        payload = torch.load(os.path.join(ck, "checkpoint.pth"), map_location="cpu",
                             weights_only=True)
        torch.save({"model": {k: v for k, v in payload["model"].items()
                              if k.startswith("encoder.")}, "step": payload["step"]},
                   os.path.join(out, "checkpoint.pth"))
        shutil.copy(os.path.join(ck, "meta.json"), out)


def run_study(workdir, knobs: Knobs, preset=None, stages=None, device="cuda"):
    """Run the plan's selected stages that have not finished; print the
    script's results block and write WORKDIR/results.json."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the validation study trains on CUDA and no card is visible; "
                           "--device cpu runs it on the CPU")
    workdir = os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    names = [s.name for s in plan(workdir, knobs, preset)]
    selected = stages or names
    unknown = sorted(set(selected) - set(names))
    if unknown:
        raise ValueError(f"--stages {unknown}: this plan's stages are {names}")
    check_flags(plan(workdir, knobs, preset))
    # each stage's flags from the directories as they are when it starts
    # (the newest pre-training checkpoint, the SSL arm's final one)
    while pending := to_run(plan(workdir, knobs, preset), selected, workdir):
        run_stage(pending[0], workdir, device)
    final = plan(workdir, knobs, preset)
    res = results(final, workdir)
    res["knobs"], res["preset"] = dataclasses.asdict(knobs), preset
    with open(os.path.join(workdir, "results.json"), "w") as f:
        json.dump(res, f, indent=1)
    print("=== results (best test word accuracy per arm) ===")
    for ft in sorted(glob.glob(os.path.join(workdir, "ft_*"))):
        best = re.findall(r"max accuracy: [0-9.]*", read(os.path.join(ft, "screen.txt")))
        print(f"{os.path.basename(ft)}: {best[-1] if best else ''}")
    builds = sorted({st["opencv"] for st in res["stages"].values() if "opencv" in st})
    if builds:
        print(f"corpora rendered with OpenCV {', '.join(builds)}")
    return res


def parse_args(argv=None):
    """(args, knobs): the preset's knobs under the ones given as flags."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir", nargs="?", default="/tmp/ssl_study")
    for f in dataclasses.fields(Knobs):
        ap.add_argument(f"--{f.name}", default=None, type=type(f.default))
    ap.add_argument("--preset", choices=sorted(PRESETS))
    ap.add_argument("--stages", default="", help="comma-separated stage names")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--carry_to", default="",
                    help="at the end, copy what a later call needs here (see `carry`)")
    args = ap.parse_args(argv)
    given = {f.name: getattr(args, f.name) for f in dataclasses.fields(Knobs)
             if getattr(args, f.name) is not None}
    return args, Knobs(**{**(PRESETS[args.preset]["knobs"] if args.preset else {}), **given})


def main(argv=None):
    args, knobs = parse_args(argv)
    try:
        run_study(args.workdir, knobs, args.preset,
                  [s for s in args.stages.split(",") if s] or None, args.device)
    finally:
        if args.carry_to:
            carry(os.path.abspath(args.workdir), args.carry_to)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stage-child"]:  # started by run_stage
        sys.exit(stage_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
