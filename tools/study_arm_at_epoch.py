#!/usr/bin/env python3
"""The validation study's SSL arm, read early: the port's runner
(`dig_tpu_torch/tools/validation_study.py`) for the corpora and the
pre-training, then `ft_ssl`'s recipe stopped once its log holds
`--stop_epoch` epochs.

    python3 tools/study_arm_at_epoch.py WORKDIR --stop_epoch 20 \\
        [--unlabeled 49920 --pre_epochs 12 --labeled 12000 --test 3000 \\
         --words 400 --ft_epochs 60] [--device cuda] [--carry_to DIR]

The knobs are the runner's.  Stages whose records stand in WORKDIR are
skipped, as the runner skips them: corpora rendered on another machine
(`validation_study WORKDIR --stages corpusA,corpusB --device cpu`) and
copied into WORKDIR are read as they are, and their records name the
OpenCV build that drew them.  `ft_ssl` runs with the plan's argv (the
recipe's schedule over `--ft_epochs`), in a session of its own; once its
log.txt holds `--stop_epoch` epochs the session is ended.  Prints, and
writes to WORKDIR/arm.json, the test word accuracy by epoch, the
pre-training losses, the stages' seconds, the corpora's OpenCV builds and
the card's name and power limit.  `--carry_to` copies the records and logs
(`validation_study.carry`).
"""

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dig_tpu_torch.tools import validation_study as vs  # noqa: E402


def epochs_logged(out):
    return [json.loads(x) for x in vs.read(os.path.join(out, "log.txt")).splitlines() if x]


def run_until(stage, workdir, device, stop_epoch, poll_s=5.0):
    """`stage` as `vs.run_stage` runs it, its session ended once its
    log.txt holds `stop_epoch` epochs (or when it exits).  Returns its
    seconds."""
    if os.path.isdir(stage.out):
        shutil.rmtree(stage.out)
    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    log_path = os.path.join(workdir, "logs", f"{stage.name}.log")
    argv = [sys.executable, "-m", "dig_tpu_torch.tools.validation_study", "--stage-child",
            device, *stage.argv[1:]]
    print(f"[{stage.name}] {' '.join(stage.argv)} (ended after epoch {stop_epoch})", flush=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=vs.ROOT, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            while proc.poll() is None and len(epochs_logged(stage.out)) < stop_epoch:
                if time.perf_counter() - t0 > stage.timeout:
                    break
                time.sleep(poll_s)
        finally:
            for pid in vs.session_processes(proc.pid):
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t0
    got = len(epochs_logged(stage.out))
    if got < stop_epoch:
        raise RuntimeError(f"{stage.name} logged {got} epochs of {stop_epoch} (exit "
                           f"{proc.returncode}); its log {log_path} ends:\n"
                           f"{vs.read(log_path)[-3000:]}")
    print(f"[{stage.name}] {got} epochs in {seconds:.1f} s", flush=True)
    return seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stop_epoch", type=int, default=20)
    own, rest = ap.parse_known_args(argv)
    args, knobs = vs.parse_args(rest)
    workdir = os.path.abspath(args.workdir)
    try:
        vs.run_study(workdir, knobs, stages=["corpusA", "corpusB", "pretrain"],
                     device=args.device)
        stages = {s.name: s for s in vs.plan(workdir, knobs)}
        seconds = run_until(stages["ft_ssl"], workdir, args.device, own.stop_epoch)
        res = vs.results([stages[n] for n in ("corpusA", "corpusB", "pretrain")], workdir)
        arm = vs.arm_result(stages["ft_ssl"].out)
        acc = arm["word_acc_by_epoch"]
        out = {"card": res["card"], "knobs": dataclasses.asdict(knobs),
               "opencv": {n: st.get("opencv") for n, st in res["stages"].items()
                          if n.startswith("corpus")},
               "seconds": {**{n: st["seconds"] for n, st in res["stages"].items()},
                           "ft_ssl": seconds},
               "pretrain": res.get("pretrain"), "ft_ssl_init": arm["init"],
               "ft_ssl_word_acc_by_epoch": acc,
               "ft_ssl_word_acc_at": {e: acc[e - 1] for e in (5, 10, 15, 20)
                                      if e <= len(acc)}}
        with open(os.path.join(workdir, "arm.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))
    finally:
        if args.carry_to:
            vs.carry(workdir, args.carry_to)
            if os.path.exists(os.path.join(workdir, "arm.json")):
                shutil.copy(os.path.join(workdir, "arm.json"), args.carry_to)
    return 0


if __name__ == "__main__":
    sys.exit(main())
