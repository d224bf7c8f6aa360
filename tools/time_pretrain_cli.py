#!/usr/bin/env python3
"""Time the port's pre-training CLI on the card under several loader settings.

    python3 tools/time_pretrain_cli.py [--records N] [--epochs N]

Writes an LMDB of seeded PNG word images (24-72 x 40-360 pixels) to a
temporary directory and runs `dig_tpu_torch.cli.run_pretrain.main` on it at
the `PretrainConfig` defaults (the full-width model, bf16, batch 128), once
for each setting: host SeqCLR augmentation or `--device_aug`, thread or
process workers, several worker counts.  For each run it prints, from the
CLI's own screen.txt, the last epoch's ms a step over the whole epoch (the
start of the loader's pool and its first batch included) and over the
epoch's last 20 steps (the window of the CLI's meters: the steady state),
the images/s of that window, and the ms a step of it spent waiting for the
loader; and beside them the bare step on one resident batch, with no loader
running and with a loader of worker threads running beside it whose batches
are dropped (what sharing the host's cores and the interpreter lock with the
loader costs the step, apart from any waiting for data).  The runs take
turns on one card in one call.  Needs a CUDA device.
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BATCH = 128
SETTINGS = (  # (tag, extra argv)
    ("host aug, 10 threads", []),
    ("device_aug, 10 threads", ["--device_aug"]),
    ("device_aug, 4 threads", ["--device_aug", "--num_workers", "4"]),
    ("device_aug, 2 threads", ["--device_aug", "--num_workers", "2"]),
    ("device_aug, 4 processes", ["--device_aug", "--worker_type", "process", "--num_workers", "4"]),
    ("host aug, 8 processes", ["--worker_type", "process", "--num_workers", "8"]),
)


def write_lmdb(path, n):
    import cv2

    from dig_tpu_torch.data.lmdb_store import LmdbWriter

    rng = np.random.default_rng(6)
    with LmdbWriter(path) as w:
        for i in range(1, n + 1):
            img = rng.integers(0, 256, (24 + 8 * (i % 7), 40 + 32 * (i % 11), 3), dtype=np.uint8)
            ok, buf = cv2.imencode(".png", img)
            assert ok
            w.put(b"image-%09d" % i, buf.tobytes())
        w.put(b"num-samples", str(n).encode())


def drain_loader(db, workers, num_view, stop):
    """Iterate a loader over the LMDB, epoch after epoch, dropping its
    batches, until `stop` is set."""
    from dig_tpu_torch.data.dataset import build_pretraining_dataset
    from dig_tpu_torch.data.pipeline import make_train_loader

    ds = build_pretraining_dataset([db], num_view=num_view, rng=np.random.default_rng(0))
    loader = make_train_loader(ds, local_batch=BATCH, rank=0, world=1, seed=0,
                               num_workers=workers)
    while not stop.is_set():
        for _ in loader:
            if stop.is_set():
                break


def bare_step_ms(steps=10, warmup=3, beside=None):
    """The step alone on one batch that already lies on the card; with
    `beside` = (db, workers, num_view), while such a loader runs."""
    from dig_tpu_torch.cli.run_pretrain import build_model
    from dig_tpu_torch.config import PretrainConfig
    from dig_tpu_torch.optim import create_optimizer
    from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
    from dig_tpu_torch.utils.schedules import (
        contrast_weight_schedule,
        cosine_schedule,
        moco_momentum_schedule,
    )

    cfg = PretrainConfig().finalize(1)
    model = build_model(cfg, "cuda")
    n = 1000
    opt = create_optimizer(cfg.opt, model.named_parameters(),
                           cosine_schedule(cfg.absolute_lr, cfg.min_lr, cfg.epochs, n,
                                           start_warmup_value=cfg.warmup_lr,
                                           warmup_steps=cfg.warmup_steps),
                           cosine_schedule(cfg.weight_decay, cfg.weight_decay_end, cfg.epochs, n))
    state = init_pretrain_state(model, opt)
    step = make_pretrain_step(model, moco_momentum_schedule(cfg.moco_m, cfg.epochs, n),
                              contrast_weight_schedule(cfg.loss_weight_contrast, cfg.epochs, n,
                                                       warmup_steps=cfg.contrast_warmup_steps))
    g = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand(BATCH, 2, model.num_patches, generator=g, device="cuda")
    batch = {"images": torch.randint(0, 256, (BATCH, 32, 128, 3), generator=g, device="cuda",
                                     dtype=torch.uint8),
             "aug_images": torch.randint(0, 256, (BATCH, 32, 128, 3), generator=g, device="cuda",
                                         dtype=torch.uint8),
             "mask": u.argsort(-1).argsort(-1) < 179}
    stop, thread = threading.Event(), None
    if beside is not None:
        thread = threading.Thread(target=drain_loader, args=(*beside, stop), daemon=True)
        thread.start()
        time.sleep(1.0)  # the loader's pool is up and decoding
    for _ in range(warmup):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    stop.set()
    if thread is not None:
        thread.join()
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_pretrain_cli: no CUDA device visible", file=sys.stderr)
        return 1
    from dig_tpu_torch.cli.run_pretrain import main as pretrain_main
    from dig_tpu_torch.config import PretrainConfig, parse_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"{len(os.sched_getaffinity(0))} cores; {args.records} records, batch {BATCH}, "
          f"{args.records // BATCH} steps an epoch, {args.epochs} epochs; the last epoch is read")
    print(f"RESULT bare step, resident batch, before: {bare_step_ms():.1f} ms")
    with tempfile.TemporaryDirectory() as d:
        db = os.path.join(d, "words")
        write_lmdb(db, args.records)
        for i, (tag, extra) in enumerate(SETTINGS):
            out = os.path.join(d, f"run{i}")
            cfg = parse_config(PretrainConfig, ["--image_alone_path", db, "--output_dir", out,
                                                "--epochs", str(args.epochs), *extra])
            pretrain_main(cfg)
            torch.cuda.synchronize()
            with open(os.path.join(out, "screen.txt")) as f:
                screen = f.read()
            epoch = args.epochs - 1
            s_it = float(re.search(rf"Epoch: \[{epoch}\] Total time: \S+ \(([0-9.]+) s / it\)",
                                   screen).group(1))
            s_win, s_data = (float(x) for x in re.findall(
                rf"Epoch: \[{epoch}\] \[\d+/\d+\].*time: ([0-9.]+)  data: ([0-9.]+)", screen)[-1])
            print(f"RESULT {tag}: {s_it * 1e3:.1f} ms a step over the epoch; its last 20 steps "
                  f"{s_win * 1e3:.1f} ms a step, {BATCH / s_win:.1f} images/s, "
                  f"{s_data * 1e3:.1f} ms a step waiting for the loader")
        print(f"RESULT bare step, resident batch, after: {bare_step_ms():.1f} ms")
        for tag, workers, num_view in (("10 threads, num_view=1", 10, 1),
                                       ("2 threads, num_view=1", 2, 1),
                                       ("10 threads, host aug", 10, 2)):
            # a few steps only: starved of the interpreter lock, one can take seconds
            ms = bare_step_ms(steps=4, warmup=1, beside=(db, workers, num_view))
            print(f"RESULT bare step, resident batch, beside a draining loader of {tag}: "
                  f"{ms:.1f} ms")
        print(f"RESULT bare step, resident batch, at the end: {bare_step_ms():.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
