"""Fine-tuning and evaluation entry point for scene-text recognition, on the card.

    python -m dig_tpu_torch.cli.run_finetune \
        --batch_size 256 --epochs 10 --warmup_epochs 1 \
        --model vit_small_patch4_32x128 --decoder_name tf_decoder \
        --use_abi_aug --nb_classes 97 --max_len 25 \
        --finetune pretrain_out/checkpoint-9 --data_path ... --eval_data_path ...

Counterpart of `dig_tpu.cli.run_finetune` on one device, with the same
flags and the same order of work: labelled LMDBs -> dataset -> host ABI
(or SeqCLR) augmentation on the loader's workers, or under
`--device_abi_aug` the ABI recipe on the model's device -> loader with
device prefetch -> the fine-tuning step (gradient accumulation over
`--update_freq` micro-steps in the optimizer) -> metric log -> eval on
`--eval_data_path` every `--eval_freq` steps and at each epoch's end ->
``checkpoint-best`` / ``checkpoint-{epoch}`` -> resume.  `--eval` with
`--other_test_data_folders` sweeps benchmarks into ``eval_results.json``.
Outputs under `--output_dir` as in `run_pretrain`: checkpoints,
``log.txt`` (one JSON line an epoch), ``screen.txt``, ``tb/`` and, with
`--profile_steps`, ``profile/trace.json``.

`--finetune` takes (`load_finetune_init`):
* a reference recognizer `.pth` (decoder keys present): the whole model;
* an encoder-only `.pth`: a reference SSL checkpoint, or the port's own
  pre-training ``checkpoint-N/checkpoint.pth``; the encoder is found under
  `--model_prefix`, else ``encoder.``, else ``backbone.``;
* a port checkpoint directory ``checkpoint-N/``: its ``encoder.*``
  tensors (``momentum_encoder.*`` is never taken).
A native `dig_tpu` directory is refused (`tools/export_pth.py` converts
it).  A `.pth` switches GELU to the erf form unless `--exact_gelu` says
otherwise, as in `dig_tpu` (weights trained under torch's erf GELU); a
directory keeps tanh, the form the port pre-trains with.

Every random draw of a step comes from a generator seeded with (seed,
stream, micro-step) (`utils/rng.py`): stream 0 the step's dropout, stream 1
the on-device augmentation.  The micro-step is ``epoch * len(loader) +
it``; the JAX CLI's ``epoch * steps_per_epoch + it`` overlaps across epochs
when `--update_freq` > 1, and is not copied.  Under `--device_abi_aug` the
host augments nothing (the JAX CLI still runs SeqCLR on the host there).

SIGTERM / SIGINT checkpoint at the next step boundary and exit 0 (143
without an `--output_dir`); a non-finite loss exits 1.  Runs on CUDA;
`main(cfg, device="cpu")` runs the plain versions of the kernels.  stdout
is teed into ``screen.txt``, and the signal handlers and the GELU form are
set, only while `main` runs.

Refused with a message (see ROADMAP.md): `--model_kind` other than rec,
feature distillation, optimizers other than adamw, `--text_cond_vis`,
`--n_fsdp` / `--n_tensor` above 1, `--dist_eval` across processes, remote
checkpoint URIs and native `dig_tpu` checkpoint directories.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

from dig_tpu_torch.config import FinetuneConfig, config_to_json, parse_config
from dig_tpu_torch.data.dataset import build_dataset
from dig_tpu_torch.data.device_aug import device_abi_augment
from dig_tpu_torch.data.pipeline import (
    DataLoader,
    device_prefetch,
    make_train_loader,
    pinned_to_device,
)
from dig_tpu_torch.data.samplers import ShardedSampler
from dig_tpu_torch.metrics.text import accuracy as word_accuracy
from dig_tpu_torch.metrics.text import recognition_f_measure
from dig_tpu_torch.models.rec_model import build_rec_model
from dig_tpu_torch.ops import activations
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.optim import create_optimizer, frozen_encoder_mask
from dig_tpu_torch.train.finetune import init_finetune_state, make_eval_step, make_finetune_step
from dig_tpu_torch.utils.charset import build_charset
from dig_tpu_torch.utils.checkpoint import (
    auto_resume,
    convert_torch_encoder,
    convert_torch_recognizer,
    has_decoder_keys,
    load_into_state,
    load_torch_checkpoint,
    merge_pretrained_tree,
    prune_checkpoints,
    refuse_unreadable,
    restore_checkpoint,
    save_checkpoint,
)
from dig_tpu_torch.utils.logging import JsonlLogger, ScreenTee, TensorboardLogger
from dig_tpu_torch.utils.metric_logger import MetricLogger
from dig_tpu_torch.utils.preemption import PreemptionGuard
from dig_tpu_torch.utils.profiling import StepTraceWindow
from dig_tpu_torch.utils.rng import step_generator
from dig_tpu_torch.utils.schedules import cosine_schedule

PRINT_FREQ = 100  # steps between reads of the metrics to the host


def build_model(cfg: FinetuneConfig, device):
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return build_rec_model(
        cfg.model, cfg.decoder_name, cfg.nb_classes, cfg.max_len, drop_rate=cfg.drop,
        attn_drop_rate=cfg.attn_drop_rate, drop_path_rate=cfg.drop_path,
        use_1d_attdec=cfg.use_1d_attdec, use_mean_pooling=cfg.use_mean_pooling, dtype=dtype,
        model_kind=cfg.model_kind, seed=cfg.seed, device=device)


def _refuse_unported(cfg: FinetuneConfig) -> None:
    """Raise for every flag whose code is not ported, before anything is
    built or written."""
    if cfg.model_kind != "rec":
        raise NotImplementedError(f"--model_kind {cfg.model_kind!r} is not ported yet (rec only; "
                                  f"see ROADMAP.md)")
    if cfg.use_feat_distill or cfg.teacher_ckpt:
        raise NotImplementedError("feature distillation (--use_feat_distill, --teacher_ckpt) is "
                                  "not ported yet; see ROADMAP.md")
    if cfg.opt.lower() != "adamw":
        raise NotImplementedError(f"--opt {cfg.opt!r} is not ported yet (adamw only; "
                                  f"see ROADMAP.md)")
    if cfg.text_cond_vis:
        raise NotImplementedError("--text_cond_vis (the text-conditional decoder) is not ported "
                                  "yet; see ROADMAP.md")
    if cfg.n_fsdp > 1 or cfg.n_tensor > 1:
        raise NotImplementedError(
            f"--n_fsdp {cfg.n_fsdp} / --n_tensor {cfg.n_tensor}: sharded training is not "
            f"ported yet (one device only; see ROADMAP.md)")
    if cfg.dist_eval and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("--dist_eval across processes is not ported yet (one process "
                                  "evaluates the whole set; see ROADMAP.md)")
    if cfg.resume.endswith((".pth", ".pt")):
        raise ValueError("--resume expects a checkpoint directory; to initialize from a torch "
                         f".pth use --finetune (got --resume {cfg.resume})")
    for path in (cfg.resume, cfg.finetune):
        if path:
            refuse_unreadable(path)


def load_finetune_init(cfg: FinetuneConfig, model) -> int:
    """`--finetune` surgery onto `model`, in place (`dig_tpu/cli/run_finetune.py:74-102`):
    a recognizer `.pth` gives the whole model; an encoder-only `.pth` or a
    port checkpoint directory its encoder.  Returns the tensors copied."""
    path = cfg.finetune
    if path.endswith((".pth", ".pt")):
        sd = load_torch_checkpoint(path, model_key=cfg.model_key)
        if has_decoder_keys(sd):
            tree = convert_torch_recognizer(sd)
        else:
            tree = {"encoder": convert_torch_encoder(sd, prefix=cfg.model_prefix or "encoder.")}
    else:
        payload = restore_checkpoint(path)
        tree = {"encoder": convert_torch_encoder(payload["model"], prefix="encoder.")}
    n = merge_pretrained_tree(model, tree)
    print(f"[finetune] {n} tensors initialized from {path} "
          f"({', '.join(f'{k}: {len(v)}' for k, v in tree.items())} in the file)")
    return n


def evaluate_benchmark(cfg: FinetuneConfig, data_path: str, eval_fn, charset, device) -> dict:
    """Greedy or beam decoding over one benchmark LMDB
    (`dig_tpu/cli/run_finetune.py:105-188`): the last partial batch padded
    to the batch size (zero images and targets, length 1), per-row losses
    summed with the padding rows sliced off.  Prints the JAX CLI's line;
    returns {"acc", "n", "fmeasure"}."""
    ds = build_dataset(data_path, is_train=False, voc_type=cfg.voc_type, max_len=cfg.max_len,
                       img_height=cfg.input_h, img_width=cfg.input_w)
    bs = cfg.batch_size
    loader = DataLoader(ds, ShardedSampler(len(ds), shuffle=False), batch_size=bs,
                        num_workers=cfg.num_workers, drop_last=False)
    n_correct, n_total, f_sum, loss_sum = 0.0, 0, 0.0, 0.0
    for images, targets, lens in loader:
        n = images.shape[0]
        if n < bs:
            pad = bs - n
            images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), images.dtype)])
            targets = np.concatenate([targets, np.zeros((pad, targets.shape[1]), targets.dtype)])
            lens = np.concatenate([lens, np.ones((pad,), lens.dtype)])
        ids, loss = eval_fn(pinned_to_device({"images": images, "targets": targets,
                                              "lengths": lens}, device))
        ids = ids[:n].cpu().numpy()
        acc = word_accuracy(ids, targets[:n], charset)
        n_correct += acc * n
        n_total += n
        f_sum += recognition_f_measure(ids, targets[:n], charset) * n
        loss_sum += float(loss[:n].sum())
    acc = n_correct / max(n_total, 1)
    # beam computes no teacher-forced loss (0 by convention in the step)
    loss_str = "n/a" if cfg.beam_width > 0 else f"{loss_sum / max(n_total, 1):.4f}"
    print(f"* {data_path}: {int(n_total)} images, Acc {acc:.4f} loss {loss_str} "
          f"Rec_fmeasure {f_sum / max(n_total, 1):.4f}")
    return {"acc": acc, "n": int(n_total), "fmeasure": f_sum / max(n_total, 1)}


def main(cfg: FinetuneConfig, device="cuda"):
    _refuse_unported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_finetune runs on CUDA and no card is visible; "
                           "call main(cfg, device='cpu') for the CPU")
    tee = None
    if cfg.output_dir:
        os.makedirs(cfg.output_dir, exist_ok=True)
        tee = ScreenTee(cfg.output_dir).install()
    exact_before = activations.EXACT
    try:
        return _run(cfg, device)
    finally:
        activations.set_exact(exact_before)
        if tee is not None:
            tee.close()


def _run(cfg: FinetuneConfig, device):
    print(config_to_json(cfg))
    # the GELU form, before any model code runs: weights from a torch .pth
    # were trained under the erf form (dig_tpu/ops/activations.py)
    exact = activations.resolve_exact_gelu(cfg.exact_gelu, (cfg.finetune, cfg.resume))
    if exact and cfg.exact_gelu is None:
        print("torch checkpoint requested: using exact (erf) GELU "
              "(override with --exact_gelu false)")
    activations.set_exact(exact)
    cfg.finalize(1)
    print(f"devices: 1 ({device}), lr: {cfg.absolute_lr:.2e}")
    charset = build_charset(cfg.voc_type, cfg.max_len)
    if charset.num_classes != cfg.nb_classes:
        raise ValueError(f"--voc_type {cfg.voc_type} has {charset.num_classes} classes, "
                         f"--nb_classes is {cfg.nb_classes}")
    model = build_model(cfg, device)
    eval_fn = make_eval_step(model, beam_width=cfg.beam_width, eos=charset.eos_id)

    if cfg.eval:
        if cfg.finetune:
            load_finetune_init(cfg, model)
        elif cfg.resume:
            model.load_state_dict(restore_checkpoint(cfg.resume)["model"])
        paths = [p for p in [cfg.eval_data_path] + list(cfg.other_test_data_folders) if p]
        results = [dict(path=p, **evaluate_benchmark(cfg, p, eval_fn, charset, device))
                   for p in paths]
        total = sum(r["n"] for r in results)
        avg = sum(r["acc"] * r["n"] for r in results) / max(total, 1)
        print(f"average word accuracy over {len(results)} benchmarks: {avg:.4f}")
        if cfg.output_dir:
            with open(os.path.join(cfg.output_dir, "eval_results.json"), "w") as f:
                json.dump({"benchmarks": results, "average_acc": avg, "n_images": int(total),
                           "beam_width": cfg.beam_width}, f, indent=2)
        return results
    guard = PreemptionGuard.install()
    try:
        return _train(cfg, device, model, eval_fn, charset, guard)
    finally:
        guard.uninstall()


def _train(cfg: FinetuneConfig, device, model, eval_fn, charset, guard):
    device_abi = cfg.device_abi_aug and cfg.use_abi_aug
    train_ds = build_dataset(
        cfg.data_path, is_train=True, voc_type=cfg.voc_type, max_len=cfg.max_len,
        num_samples=cfg.num_samples, use_aug=cfg.num_view > 1 and not device_abi,
        use_abi_aug=cfg.use_abi_aug, img_height=cfg.input_h, img_width=cfg.input_w,
        rng=np.random.default_rng(cfg.seed))
    loader = make_train_loader(
        train_ds, local_batch=cfg.batch_size, rank=0, world=1, seed=cfg.seed,
        num_workers=cfg.num_workers, worker_type=cfg.worker_type,
        batch_wise_shuffle=cfg.batch_wise_shuffle)
    micro_steps = len(loader)  # loader batches an epoch; updates: // update_freq
    steps_per_epoch = micro_steps // cfg.update_freq
    print(f"train: {len(train_ds)} imgs, {steps_per_epoch} steps/epoch")

    lr_sched = cosine_schedule(
        cfg.absolute_lr, cfg.min_lr, cfg.epochs, steps_per_epoch,
        warmup_epochs=cfg.warmup_epochs, start_warmup_value=cfg.warmup_lr,
        warmup_steps=cfg.warmup_steps)
    wd_sched = cosine_schedule(cfg.weight_decay, cfg.weight_decay_end, cfg.epochs,
                               steps_per_epoch)
    optimizer = create_optimizer(
        cfg.opt, model.named_parameters(), lr_sched, wd_sched, betas=cfg.opt_betas,
        eps=cfg.opt_eps, clip_grad=cfg.clip_grad, layer_decay=cfg.layer_decay,
        num_layers=model.encoder.depth,
        frozen=frozen_encoder_mask(cfg.fixed_encoder_layers)
        if cfg.fixed_encoder_layers > 0 else None,
        update_freq=cfg.update_freq)
    state = init_finetune_state(model, optimizer)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"params: {n_params / 1e6:.2f} M")

    if cfg.finetune:
        load_finetune_init(cfg, model)
    start_epoch = cfg.start_epoch
    if cfg.resume:
        payload = restore_checkpoint(cfg.resume)
        load_into_state(state, payload)
        start_epoch = int(payload.get("extra", {}).get("epoch", -1)) + 1
    elif cfg.auto_resume and cfg.output_dir:
        state, extra = auto_resume(cfg.output_dir, state)
        if extra is not None:
            start_epoch = int(extra.get("epoch", -1)) + 1

    step_fn = make_finetune_step(model, smoothing=cfg.smoothing)
    aug_fn = None
    if device_abi:
        def aug_fn(generator, images):  # uint8 transport: normalize before the [-1, 1] ops
            return device_abi_augment(generator, to_model_images(images))

    tb = TensorboardLogger(cfg.log_dir or os.path.join(cfg.output_dir, "tb"))
    jsonl = JsonlLogger(cfg.output_dir)
    tracer = StepTraceWindow(os.path.join(cfg.output_dir, "profile"), cfg.profile_steps,
                             cfg.profile_start_step)
    max_accuracy = 0.0

    def to_device(item):
        images, targets, lens = item
        return pinned_to_device({"images": images, "targets": targets, "lengths": lens}, device)

    def eval_and_keep_best(epoch):
        nonlocal max_accuracy
        stats = evaluate_benchmark(cfg, cfg.eval_data_path, eval_fn, charset, device)
        if stats["acc"] > max_accuracy:
            max_accuracy = stats["acc"]
            if cfg.output_dir and cfg.save_ckpt and cfg.save_best:
                save_checkpoint(cfg.output_dir, "best", state,
                                extra={"epoch": epoch, "acc": stats["acc"]})
        return stats

    for epoch in range(start_epoch, cfg.epochs):
        loader.sampler.set_epoch(epoch)
        logger = MetricLogger()
        batches = device_prefetch(iter(loader), to_device)
        for it, batch in enumerate(logger.log_every(batches, PRINT_FREQ, f"Epoch: [{epoch}]",
                                                    total=steps_per_epoch)):
            gstep = epoch * micro_steps + it
            if aug_fn is not None:
                batch["images"] = aug_fn(step_generator(cfg.seed + 1, 1, gstep, device),
                                         batch["images"])
            state, metrics, pred_ids = step_fn(state, batch,
                                               step_generator(cfg.seed + 1, 0, gstep, device))
            tracer.tick()
            if guard.should_stop:
                # extra epoch - 1: auto-resume redoes this epoch's data with
                # the mid-epoch optimizer state
                tracer.close()
                guard.checkpoint_and_exit(cfg.output_dir, lambda: save_checkpoint(
                    cfg.output_dir, epoch, state, extra={"epoch": epoch - 1}),
                    f"epoch {epoch} step {it}")
            # the metrics stay on the device but for these steps
            if it % PRINT_FREQ == 0 or it == steps_per_epoch - 1:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                if not math.isfinite(host_metrics["loss"]):
                    print(f"Loss is {host_metrics['loss']}, stopping training")
                    sys.exit(1)
                host_metrics["class_acc"] = word_accuracy(
                    pred_ids.cpu().numpy(), batch["targets"].cpu().numpy(), charset)
                logger.update(**host_metrics)
                tb.update(head="loss", step=int(state.step), **host_metrics)
            if cfg.eval_freq and it >= 1 and it % cfg.eval_freq == 0 and cfg.eval_data_path:
                eval_and_keep_best(epoch)
        print("Averaged stats:", logger)
        stats = eval_and_keep_best(epoch) if cfg.eval_data_path else {}
        if cfg.output_dir and cfg.save_ckpt and (
            (epoch + 1) % cfg.save_ckpt_freq == 0 or epoch + 1 == cfg.epochs
        ):
            save_checkpoint(cfg.output_dir, epoch, state, extra={"epoch": epoch})
            if cfg.keep_ckpt_max > 0:
                prune_checkpoints(cfg.output_dir, cfg.keep_ckpt_max)
        jsonl.write(
            epoch=epoch,
            **{f"train_{k}": m.global_avg for k, m in logger.meters.items()},
            val_acc=stats.get("acc"), max_accuracy=max_accuracy,
        )
    print(f"max accuracy: {max_accuracy:.4f}")
    tracer.close()
    tb.flush()
    return state


if __name__ == "__main__":
    main(parse_config(FinetuneConfig))
