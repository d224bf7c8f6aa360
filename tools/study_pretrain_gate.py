#!/usr/bin/env python3
"""Go / no-go for a pre-training that must end inside one time-limited
call: watch the pretrain CLI's screen.txt and end the stage early when it
cannot finish.

    python3 tools/study_pretrain_gate.py WORKDIR/pre/screen.txt --start T0 \\
        --limit 3600 --epochs 15 --pid RUNNER_PID

T0 is the call's start (`date +%s`), RUNNER_PID the validation study's
runner.  Each "Epoch: [0] [i/N]" line is stamped with the time it is first
seen (polled every 5 s).  When epoch 0 ends, the rate is taken from the
lines' arrival from the first line at step 300 or later (the first steps
build kernels and start workers) to the last, and the end is projected as
now + the remaining epochs' steps at that rate + 30 s for the runner's
carry.  The arrival covers every step on the clock the limit runs on; the
CLI's own `time:` is a 20-step average, a fifth of the steps between lines.
A projection past LIMIT - 300 s is a no-go: the runner's stage child (the
process `run_stage` started in a session of its own) is killed with its
session, so the runner records the stage as failed and still carries its
logs.  At LIMIT - 120 s the stage is killed whatever the projection said.
A SIGTERM would not do: the CLI checkpoints on it and exits 0, and the
runner would take the partial pre-training as finished.
"""

import argparse
import os
import re
import signal
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dig_tpu_torch.tools.validation_study import session_processes  # noqa: E402

NO_GO_MARGIN_S, DEADLINE_MARGIN_S, CARRY_S, WARM_UP_STEPS = 300, 120, 30, 300


def projection(text, seen, now, epochs):
    """(message, projected end in seconds since T0), or None before epoch 0
    has ended.  `seen` maps each epoch-0 step index to the time its line was
    first seen."""
    spe = re.search(r"(\d+) steps/epoch", text)
    ep0 = re.search(r"Epoch: \[0\] Total time: ", text)
    warm = min((i for i in seen if i >= WARM_UP_STEPS), default=None)
    if not (spe and ep0 and warm is not None and max(seen) > warm):
        return None
    steps = int(spe[1])
    late = (seen[max(seen)] - seen[warm]) / (max(seen) - warm)
    proj = now + (epochs - 1) * steps * late + CARRY_S
    return (f"{now:.1f} s: epoch 0 done, {steps} steps/epoch, {late:.4f} s/step from step "
            f"{warm} on (line arrival, 5 s polls); projected end {proj:.1f} s"), proj


def stat(pid):
    """/proc/<pid>/stat's fields after the command name, or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None


def alive(pid):
    fields = stat(pid)
    return fields is not None and fields[0] != "Z"


def end_stage(why, t0, runner):
    """SIGKILLs the session of each child of `runner` that leads one: the
    stage child and its loader workers, nothing else on the machine."""
    children = [int(p) for p in filter(str.isdigit, os.listdir("/proc"))
                if (stat(p) or [None, None])[1] == str(runner)]
    killed = [pid for child in children for pid in session_processes(child)]
    for pid in killed:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    print(f"{time.time() - t0:.1f} s: ending the stage: {why}; killed {killed}", flush=True)
    return killed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("screen")
    ap.add_argument("--start", type=float, required=True)
    ap.add_argument("--limit", type=float, required=True)
    ap.add_argument("--epochs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    args = ap.parse_args(argv)
    seen, decided = {}, False
    while alive(args.pid):
        now = time.time() - args.start
        try:
            with open(args.screen) as f:
                text = f.read()
        except OSError:
            text = ""
        for i in re.findall(r"Epoch: \[0\] \[(\d+)/\d+\]", text):
            seen.setdefault(int(i), now)
        got = None if decided else projection(text, seen, now, args.epochs)
        if got:
            decided = True
            message, proj = got
            go = proj <= args.limit - NO_GO_MARGIN_S
            print(f"{message} against {args.limit - NO_GO_MARGIN_S:.0f}: "
                  f"{'GO' if go else 'NO-GO'}", flush=True)
            if not go:
                end_stage("projected past the limit less 5 minutes", args.start, args.pid)
        if now > args.limit - DEADLINE_MARGIN_S:
            end_stage("hard deadline", args.start, args.pid)
            break
        time.sleep(5)
    print(f"{time.time() - args.start:.1f} s: watcher done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
