"""The validation study's SSL transfer as a 2x2 swap across the two
packages, on the CPU: one pre-training in each package, then the SSL arm
with every pairing of encoder (jax, port) and fine-tuner (jax, port), and
the scratch arm in each package.

    python tests/_torch_port_ssl_swap.py WORKDIR [--seeds 0,1] [size knobs]

Stages, each a process of its own (so that neither package's threads or
compiled programs reach the other's), run and recorded by the study
runner's `run_stage` (a finished stage is skipped on a second call; a stage
that fails ends the run once the stages beside it have ended):

* the corpora: `tools/gen_synth.py` with the study's flags (`--easy
  --test_pool shared`, seeds 3 and 5), at `--unlabeled` / `--labeled` /
  `--test` images over `--words` words;
* `pre_jax`, `pre_port`: the study's pre-training recipe (`--device_aug`,
  batch 128, `--warmup_steps`) at the micro width, one loader worker, in fp32
  (the CPU's own dtype in both packages);
* `export_port`: the port's checkpoint through
  `python -m dig_tpu_torch.tools.export_pth <ckpt> enc.pth --encoder_only`,
  the form `dig_tpu`'s `--finetune` reads (with `--exact_gelu false`: both
  packages pre-trained with the tanh GELU);
* arms `ssl_<encoder>_<finetuner>_s<seed>` and `scratch_<finetuner>_s<seed>`:
  the study's arm recipe (batch 128, lr 8e-4, warm-up 2 epochs, one
  worker) at the micro width; the port's fine-tuner reads `dig_tpu`'s native
  checkpoint directory as it is (`utils/native_ckpt.py`).

Stages that do not need each other run side by side; give them threads with
OMP_NUM_THREADS and XLA_FLAGS.  The last line printed is a JSON object: per
arm the tensors its `--finetune` reported, the word accuracy by epoch and
the best; `WORKDIR/swap.json` holds the same."""

import argparse
import concurrent.futures
import glob
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the `[finetune] N tensors initialized from ...` line of the port's CLI,
# and the count printed by `dig_tpu`'s wrapper below
INIT_RE = re.compile(r"\[finetune\] (\d+) tensors initialized from (\S+)")
PRE_MODEL = "pretrain_simmim_moco_ori_vit_micro_patch4_32x128"
FT_MODEL = "vit_micro_patch4_32x128"


def corpus_argv(kind, out, args):
    if kind == "A":
        counts = ["--train", str(args.unlabeled), "--labeled", "100", "--test", "100",
                  "--train_words", "1500", "--seed", "3"]
    else:
        counts = ["--train", "100", "--labeled", str(args.labeled), "--test", str(args.test),
                  "--train_words", str(args.words), "--seed", "5"]
    return [os.path.join(ROOT, "tools", "gen_synth.py"), out, "--easy", "--test_pool", "shared",
            *counts, "--test_words", "10", "--max_word_len", "6"]


def pretrain_flags(args, corpus_a, out):
    return ["--model", PRE_MODEL, "--image_alone_path", os.path.join(corpus_a, "train"),
            "--batch_size", str(args.batch_size), "--epochs", str(args.pre_epochs),
            "--warmup_steps", str(args.warmup_steps), "--device_aug", "--num_workers", "1",
            "--output_dir", out, "--eval_freq", "0", "--dtype", "float32", "--seed", "0",
            "--moco_mlp_dim", str(args.moco_mlp_dim), "--moco_dim", str(args.moco_dim)]


def finetune_flags(args, corpus_b, out, seed, init=None):
    flags = ["--model", FT_MODEL, "--decoder_name", "small_tf_decoder",
             "--data_path", os.path.join(corpus_b, "labeled"),
             "--eval_data_path", os.path.join(corpus_b, "test"),
             "--batch_size", str(args.batch_size), "--epochs", str(args.ft_epochs),
             "--warmup_epochs", "2", "--num_workers", "1", "--lr", "8e-4", "--no_save_ckpt",
             "--output_dir", out, "--eval_freq", "0", "--seed", str(seed), "--dtype", "float32"]
    if init:
        flags += ["--finetune", init, "--exact_gelu", "false"]
    return flags


def cli_argv(pkg, cli, flags):
    """A stage's interpreter arguments: the port's CLIs as the study runs
    them, `dig_tpu`'s through this file's `--child`."""
    if pkg == "port":
        return ["-m", f"dig_tpu_torch.cli.{cli}", *flags]
    return [os.path.abspath(__file__), "--child", cli, *flags]


def run_jax_cli(cli, flags):
    """Child entry: one of `dig_tpu`'s CLIs in this process, on the CPU;
    the fine-tuner prints how many tensors `--finetune` changed, as the
    port's does."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dig_tpu import config as jcfg

    if cli == "run_pretrain":
        from dig_tpu.cli.run_pretrain import main

        main(jcfg.parse_config(jcfg.PretrainConfig, flags))
        return
    import numpy as np
    from dig_tpu.cli import run_finetune as rf

    load = rf.load_finetune_init

    def counted(cfg, state, model=None):
        new = load(cfg, state, model)
        n = sum(1 for a, b in zip(jax.tree_util.tree_leaves(state.params),
                                  jax.tree_util.tree_leaves(new.params))
                if not np.array_equal(np.asarray(a), np.asarray(b)))
        print(f"[finetune] {n} tensors initialized from {cfg.finetune}", flush=True)
        return new

    rf.load_finetune_init = counted
    rf.main(jcfg.parse_config(jcfg.FinetuneConfig, flags))


def last_checkpoint(out):
    cks = [p for p in glob.glob(os.path.join(out, "checkpoint-*"))
           if re.fullmatch(r"checkpoint-\d+", os.path.basename(p))]
    return max(cks, key=lambda p: int(p.rsplit("-", 1)[1]))


def arm_result(workdir, name):
    with open(os.path.join(workdir, name, "log.txt")) as f:
        accs = [json.loads(line)["val_acc"] for line in f]
    with open(os.path.join(workdir, "logs", name + ".log")) as f:
        init = INIT_RE.findall(f.read())
    return {"init_tensors": int(init[-1][0]) if init else None,
            "init_from": init[-1][1] if init else None, "word_acc": accs, "best": max(accs)}


def pretrain_last_epoch(workdir, pkg):
    """The pre-training's last log.txt line: its epoch's mean losses."""
    with open(os.path.join(workdir, "pre_" + pkg, "log.txt")) as f:
        row = json.loads(f.read().splitlines()[-1])
    return {k: round(v, 4) for k, v in row.items()
            if k in ("epoch", "train_loss_contrast", "train_loss_pixel", "train_q1_acc1")}


def stage_env(workdir):
    """The stages' environment: one CPU device for JAX, and TensorBoard
    scalars off (a stand-in `tensorflow` that fails to import: both CLIs
    then skip them, and its import alone takes seconds)."""
    stub = os.path.join(workdir, "no_tf")
    os.makedirs(os.path.join(stub, "tensorflow"), exist_ok=True)
    with open(os.path.join(stub, "tensorflow", "__init__.py"), "w") as f:
        f.write("raise ImportError('TensorBoard scalars off')\n")
    os.environ["XLA_FLAGS"] = " ".join([os.environ.get("XLA_FLAGS", ""),
                                        "--xla_force_host_platform_device_count=1"]).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [stub, ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))


def main(argv=None):
    from dig_tpu_torch.tools.validation_study import Stage, finished, run_stage

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--unlabeled", type=int, default=8192)
    ap.add_argument("--labeled", type=int, default=2048)
    ap.add_argument("--test", type=int, default=512)
    ap.add_argument("--words", type=int, default=100)
    ap.add_argument("--pre_epochs", type=int, default=4)
    ap.add_argument("--warmup_steps", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=128, help="both stages' (the study's: 128)")
    # the MoCo heads' widths (the study's: 4096 / 256); the Tier-1 case narrows
    # them, which leaves the encoder that the arms read as it is
    ap.add_argument("--moco_mlp_dim", type=int, default=4096)
    ap.add_argument("--moco_dim", type=int, default=256)
    ap.add_argument("--ft_epochs", type=int, default=20)
    ap.add_argument("--seeds", default="0", help="fine-tuning seeds, comma-separated")
    args = ap.parse_args(argv)
    w = os.path.abspath(args.workdir)
    stage_env(w)

    def wave(*stages):  # stages that do not need each other, side by side
        todo = [s for s in stages if not finished(s, w)]
        if todo:
            with concurrent.futures.ThreadPoolExecutor(len(todo)) as ex:
                list(ex.map(lambda s: run_stage(s, w, "cpu"), todo))

    ca, cb = os.path.join(w, "corpusA"), os.path.join(w, "corpusB")
    wave(Stage("corpusA", corpus_argv("A", ca, args), ca),
         Stage("corpusB", corpus_argv("B", cb, args), cb))
    seeds = [int(s) for s in args.seeds.split(",")]
    arm = {}  # name: (fine-tuner, encoder checkpoint or None, seed)
    for seed in seeds:
        for ft in ("jax", "port"):
            arm[f"scratch_{ft}_s{seed}"] = (ft, None, seed)

    def arm_stage(name):
        ft, init, seed = arm[name]
        out = os.path.join(w, name)
        return Stage(name, cli_argv(ft, "run_finetune",
                                    finetune_flags(args, cb, out, seed, init)), out)

    wave(*[Stage("pre_" + p, cli_argv(p, "run_pretrain",
                                      pretrain_flags(args, ca, os.path.join(w, "pre_" + p))),
                 os.path.join(w, "pre_" + p)) for p in ("jax", "port")],
         *[arm_stage(name) for name in arm])
    enc = {"jax": last_checkpoint(os.path.join(w, "pre_jax")),
           "port": os.path.join(w, "enc_port.pth")}
    wave(Stage("export_port", ["-m", "dig_tpu_torch.tools.export_pth",
                               last_checkpoint(os.path.join(w, "pre_port")), enc["port"],
                               "--encoder_only"], os.path.join(w, "export_port")))
    ssl = [f"ssl_{e}_{ft}_s{seed}" for seed in seeds for e in ("jax", "port")
           for ft in ("jax", "port")]
    for name in ssl:
        _, e, ft, s = name.split("_")
        arm[name] = (ft, enc[e], int(s[1:]))
    wave(*[arm_stage(name) for name in ssl])
    result = {"size": {k: v for k, v in vars(args).items() if k != "workdir"},
              "pretrain_last_epoch": {p: pretrain_last_epoch(w, p) for p in ("jax", "port")},
              "arms": {name: arm_result(w, name) for name in arm}}
    with open(os.path.join(w, "swap.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        run_jax_cli(sys.argv[2], sys.argv[3:])
    else:
        main()
