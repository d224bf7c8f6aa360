"""Fine-tuning and evaluation entry point for scene-text recognition, on the card.

    python -m dig_tpu_torch.cli.run_finetune \
        --batch_size 256 --epochs 10 --warmup_epochs 1 \
        --model vit_small_patch4_32x128 --decoder_name tf_decoder \
        --use_abi_aug --nb_classes 97 --max_len 25 \
        --finetune pretrain_out/checkpoint-9 --data_path ... --eval_data_path ...

Counterpart of `dig_tpu.cli.run_finetune`, with the same flags and the
same order of work: labelled LMDBs -> dataset -> host ABI
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

Every model kind of `dig_tpu` (`--model_kind rec | ctc | attn | seq_cls |
mim_rec`; the reference spellings `--decoder_type attention` and
`--use_seq_cls_token`), `--decoder_name decoupled_tf_decoder`,
`--text_cond_vis` and feature distillation (`--use_feat_distill
--teacher_ckpt`) train here, each with its step (`train/finetune.py`) and
its eval: word accuracy of the decoded ids, or for CTC of the collapsed
per-frame ids (`ctc_accuracy`, at every eval: the JAX CLI scores its
end-of-epoch eval of a CTC model with word accuracy of the raw frames);
with the decoupled decoder, also the multi-label F-measure of the
presence logits against the presence of every target id, padding
included (engine_for_finetuning.py:262-269).  `dig_tpu` asks for those
logits under `--model_kind seq_cls`, whose model has none (its eval
raises); here they come from the model that has them.

`--finetune` and `--teacher_ckpt` take (`load_finetune_init`):
* a reference recognizer `.pth` (decoder keys present): the whole model;
* an encoder-only `.pth`: a reference SSL checkpoint, or the port's own
  pre-training ``checkpoint-N/checkpoint.pth``; the encoder is found under
  `--model_prefix`, else ``encoder.``, else ``backbone.``;
* a port checkpoint directory ``checkpoint-N/``: its ``encoder.*``
  tensors (``momentum_encoder.*`` is never taken);
* a native `dig_tpu` directory (``arrays.npz`` + ``treedef.pkl``, read
  without JAX by `utils/native_ckpt.py`): its ``params["encoder"]`` (or the
  params themselves, an encoder's), as `dig_tpu` takes them.
The teacher is read as `--finetune` reads its input, into a second
recognizer of the student's configuration (`dig_tpu` reads its teacher
from a native directory only).  Any of these paths, `--resume` too, may
be a remote URI (fsspec).  A learnable ``pos_embed`` of
another grid is refitted bicubically.  A `.pth` switches GELU to the erf
form unless `--exact_gelu` says otherwise, as in `dig_tpu` (weights trained
under torch's erf GELU); a directory keeps tanh, the form the port
pre-trains with.

Every random draw of a step comes from a generator seeded with (seed,
stream, micro-step, rank) (`utils/rng.py`): stream 0 the step's dropout,
stream 1 the on-device augmentation.  The micro-step is ``epoch * len(loader) +
it``; the JAX CLI's ``epoch * steps_per_epoch + it`` overlaps across epochs
when `--update_freq` > 1, and is not copied.  Under `--device_abi_aug` the
host augments nothing (the JAX CLI still runs SeqCLR on the host there).

Data parallel, one process per card over NCCL, as `run_pretrain`:

    torchrun --nproc_per_node 8 -m dig_tpu_torch.cli.run_finetune ...

Each rank trains on its own `--batch_size` rows; the gradients are
averaged over the ranks before clipping (under `--update_freq`, once, on
the accumulated mean), so N ranks train as one process would on the
global batch.  With `--dist_eval` the eval set is split over the ranks and
their sums (correct, total, F-measure, loss) are added up; without it
every rank evaluates the whole set and rank 0's figures decide.  Only rank
0 prints and writes.

SIGTERM / SIGINT checkpoint at the next step boundary and exit 0 (143
without an `--output_dir`); a non-finite loss exits 1.  Runs on CUDA;
`main(cfg, device="cpu")` runs the plain versions of the kernels (and,
across processes, over gloo).  Process workers (`--worker_type process`)
and their server are stopped when `main` ends, on every rank.  stdout is
teed into ``screen.txt``, and the signal handlers and the GELU form are
set, only while `main` runs.

`--opt` takes every optimizer name of `dig_tpu` (`optim.py`).  `--resume`
takes a port checkpoint directory or a native `dig_tpu` one (its params
and AdamW's moments; for `--eval`, its params).  Refused with a message:
`--n_fsdp` / `--n_tensor` above 1 (not ported yet, see ROADMAP.md); and,
as in `dig_tpu`, an optimizer name it does not know, distillation with a
kind other than rec or without `--teacher_ckpt`.
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
    stop_worker_processes,
)
from dig_tpu_torch.data.samplers import ShardedSampler
from dig_tpu_torch.metrics.text import accuracy as word_accuracy
from dig_tpu_torch.metrics.text import (
    ctc_accuracy,
    multi_label_f_measure,
    recognition_f_measure,
)
from dig_tpu_torch.models.rec_model import SeqClsRecModel, build_rec_model
from dig_tpu_torch.ops import activations
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.optim import create_optimizer, frozen_encoder_mask, parse_optimizer_name
from dig_tpu_torch.parallel.dist import (
    all_reduce_floats,
    broadcast_floats,
    broadcast_module,
    destroy,
    get_rank,
    get_world_size,
    init_distributed_mode,
    mean_over_ranks,
)
from dig_tpu_torch.parallel.mesh import check_mesh, host_local_rows, local_batch
from dig_tpu_torch.train.finetune import (
    init_finetune_state,
    make_ctc_eval_step,
    make_ctc_step,
    make_distill_finetune_step,
    make_eval_step,
    make_finetune_step,
    make_mim_finetune_step,
)
from dig_tpu_torch.utils import native_ckpt
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
    restore_checkpoint,
    save_checkpoint,
)
from dig_tpu_torch.utils.logging import (
    JsonlLogger,
    ScreenTee,
    TensorboardLogger,
    is_main_process,
    stdout_on_main_process_only,
)
from dig_tpu_torch.utils.metric_logger import MetricLogger
from dig_tpu_torch.utils.preemption import STOP_POLL_STEPS, PreemptionGuard
from dig_tpu_torch.utils.profiling import StepTraceWindow
from dig_tpu_torch.utils.rng import step_generator
from dig_tpu_torch.utils.schedules import cosine_schedule

PRINT_FREQ = 100  # steps between reads of the metrics to the host
MODEL_KINDS = ("rec", "ctc", "attn", "seq_cls", "mim_rec")


def build_model(cfg: FinetuneConfig, device, use_feat_distill=None):
    """The recognizer the flags describe; `use_feat_distill` overrides the
    flag (False for the distillation teacher)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if use_feat_distill is None:
        use_feat_distill = cfg.use_feat_distill
    return build_rec_model(
        cfg.model, cfg.decoder_name, cfg.nb_classes, cfg.max_len, drop_rate=cfg.drop,
        attn_drop_rate=cfg.attn_drop_rate, drop_path_rate=cfg.drop_path,
        use_1d_attdec=cfg.use_1d_attdec, use_mean_pooling=cfg.use_mean_pooling,
        use_feat_distill=use_feat_distill, text_cond_vis=cfg.text_cond_vis,
        use_mim_proj=cfg.use_mim_proj, dtype=dtype, model_kind=cfg.model_kind, seed=cfg.seed,
        device=device)


def _refuse_unported(cfg: FinetuneConfig) -> None:
    """Raise for every flag whose code is not ported, and for the
    combinations `dig_tpu` refuses, before anything is built or written."""
    parse_optimizer_name(cfg.opt)
    check_mesh(cfg.n_fsdp, cfg.n_tensor)
    if cfg.resume.endswith((".pth", ".pt")):
        raise ValueError("--resume expects a checkpoint directory; to initialize from a torch "
                         f".pth use --finetune (got --resume {cfg.resume})")
    if cfg.model_kind not in MODEL_KINDS:
        raise ValueError(f"--model_kind {cfg.model_kind!r}: not one of {', '.join(MODEL_KINDS)}")
    if cfg.use_feat_distill and cfg.model_kind != "rec":
        raise ValueError(f"--use_feat_distill requires --model_kind rec (got {cfg.model_kind})")
    if cfg.use_feat_distill and not cfg.teacher_ckpt and not cfg.eval:
        raise ValueError("--use_feat_distill requires --teacher_ckpt "
                         "(the frozen encoder to distill from)")


def load_finetune_init(cfg: FinetuneConfig, model, path: str = "") -> int:
    """`--finetune` surgery onto `model`, in place (`dig_tpu/cli/run_finetune.py:74-102`),
    from `path` (the distillation teacher's) or else `--finetune`: a
    recognizer `.pth` gives the whole model; an encoder-only `.pth` or a
    port checkpoint directory its encoder.  Returns the tensors copied."""
    path = path or cfg.finetune
    if path.endswith((".pth", ".pt")):
        sd = load_torch_checkpoint(path, model_key=cfg.model_key)
        if has_decoder_keys(sd):
            tree = convert_torch_recognizer(sd)
        else:
            tree = {"encoder": convert_torch_encoder(sd, prefix=cfg.model_prefix or "encoder.")}
    elif "native" in (payload := restore_checkpoint(path)):
        tree = {"encoder": native_ckpt.encoder_state_dict(payload["native"])}
    else:
        tree = {"encoder": convert_torch_encoder(payload["model"], prefix="encoder.")}
    n = merge_pretrained_tree(model, tree, pos_embed_grid=model.encoder.patch_shape)
    print(f"[finetune] {n} tensors initialized from {path} "
          f"({', '.join(f'{k}: {len(v)}' for k, v in tree.items())} in the file)")
    return n


def evaluate_benchmark(cfg: FinetuneConfig, data_path: str, eval_fn, charset, device,
                       accuracy_fn=word_accuracy) -> dict:
    """Greedy or beam decoding over one benchmark LMDB
    (`dig_tpu/cli/run_finetune.py:105-188`): the last partial batch padded
    to the batch size (zero images and targets, length 1), per-row losses
    summed with the padding rows sliced off.  With `--dist_eval` each rank
    scores its share of the set (`ShardedSampler`, which repeats a few
    records to give every rank as many) and the sums are added up over the
    ranks; without it every rank scores the whole set and takes rank 0's
    sums.  Prints the JAX CLI's line; returns {"acc", "n", "fmeasure"}, and
    "multi_label_fmeasure" when `eval_fn` returns presence logits third
    (the F-measure of each batch against the presence of every target id,
    averaged over the rows)."""
    ds = build_dataset(data_path, is_train=False, voc_type=cfg.voc_type, max_len=cfg.max_len,
                       img_height=cfg.input_h, img_width=cfg.input_w)
    bs = local_batch(cfg.batch_size)
    rank, world = (get_rank(), get_world_size()) if cfg.dist_eval else (0, 1)
    loader = DataLoader(ds, ShardedSampler(len(ds), rank=rank, world=world, shuffle=False),
                        batch_size=bs, num_workers=cfg.num_workers, drop_last=False)
    n_correct, n_total, f_sum, loss_sum, ml_sum = 0.0, 0, 0.0, 0.0, 0.0
    has_cls = False
    for images, targets, lens in loader:
        n = images.shape[0]
        if n < bs:
            pad = bs - n
            images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), images.dtype)])
            targets = np.concatenate([targets, np.zeros((pad, targets.shape[1]), targets.dtype)])
            lens = np.concatenate([lens, np.ones((pad,), lens.dtype)])
        out = eval_fn(pinned_to_device({"images": images, "targets": targets,
                                        "lengths": lens}, device))
        ids = host_local_rows(out[0])[:n].cpu().numpy()
        n_correct += accuracy_fn(ids, targets[:n], charset) * n
        n_total += n
        f_sum += recognition_f_measure(ids, targets[:n], charset) * n
        loss_sum += float(host_local_rows(out[1])[:n].sum())
        if len(out) == 3:
            has_cls = True
            cls_logit = host_local_rows(out[2])[:n].float().cpu().numpy()
            presence = np.zeros((n, cls_logit.shape[-1]), np.float32)
            presence[np.arange(n)[:, None], targets[:n]] = 1.0
            ml_sum += multi_label_f_measure(cls_logit, presence) * n
    sums = [n_correct, n_total, f_sum, loss_sum, ml_sum]
    # one figure on every rank: the ranks decide on it together (checkpoint-best)
    n_correct, n_total, f_sum, loss_sum, ml_sum = (all_reduce_floats(sums) if cfg.dist_eval
                                                   else broadcast_floats(sums))
    n_total = int(n_total)
    acc = n_correct / max(n_total, 1)
    # beam computes no teacher-forced loss (0 by convention in the step)
    loss_str = "n/a" if cfg.beam_width > 0 else f"{loss_sum / max(n_total, 1):.4f}"
    print(f"* {data_path}: {int(n_total)} images, Acc {acc:.4f} loss {loss_str} "
          f"Rec_fmeasure {f_sum / max(n_total, 1):.4f}")
    result = {"acc": acc, "n": int(n_total), "fmeasure": f_sum / max(n_total, 1)}
    if has_cls:
        result["multi_label_fmeasure"] = ml_sum / max(n_total, 1)
        print(f"F_measure: {result['multi_label_fmeasure']:.4f}")
    return result


def main(cfg: FinetuneConfig, device="cuda"):
    _refuse_unported(cfg)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_finetune runs on CUDA and no card is visible; "
                           "call main(cfg, device='cpu') for the CPU")
    dist_info = init_distributed_mode(device)
    tee = None
    exact_before = activations.EXACT
    try:
        with stdout_on_main_process_only():
            if cfg.output_dir and is_main_process():
                os.makedirs(cfg.output_dir, exist_ok=True)
                tee = ScreenTee(cfg.output_dir).install()
            try:
                return _run(cfg, dist_info)
            finally:
                activations.set_exact(exact_before)
                if tee is not None:
                    tee.close()
    finally:
        if cfg.worker_type == "process":  # this rank's loader workers and their server
            stop_worker_processes()
        if dist_info["created"]:
            destroy()


def _run(cfg: FinetuneConfig, dist_info: dict):
    print(config_to_json(cfg))
    device, world = dist_info["device"], dist_info["world_size"]
    # the GELU form, before any model code runs: weights from a torch .pth
    # were trained under the erf form (dig_tpu/ops/activations.py)
    exact = activations.resolve_exact_gelu(cfg.exact_gelu, (cfg.finetune, cfg.resume))
    if exact and cfg.exact_gelu is None:
        print("torch checkpoint requested: using exact (erf) GELU "
              "(override with --exact_gelu false)")
    activations.set_exact(exact)
    cfg.finalize(world)
    backend = f", {dist_info['backend']}" if dist_info["backend"] else ""
    print(f"devices: {world} ({device}{backend}), lr: {cfg.absolute_lr:.2e}")
    charset = build_charset(cfg.voc_type, cfg.max_len)
    if charset.num_classes != cfg.nb_classes:
        raise ValueError(f"--voc_type {cfg.voc_type} has {charset.num_classes} classes, "
                         f"--nb_classes is {cfg.nb_classes}")
    model = build_model(cfg, device)
    eval_fn, accuracy_fn = make_eval(cfg, model, charset)

    if cfg.eval:
        if cfg.finetune:
            load_finetune_init(cfg, model)
        elif cfg.resume:
            payload = restore_checkpoint(cfg.resume)
            model.load_state_dict(native_ckpt.model_state_dict(payload["native"], False)
                                  if "native" in payload else payload["model"])
        paths = [p for p in [cfg.eval_data_path] + list(cfg.other_test_data_folders) if p]
        results = [dict(path=p, **evaluate_benchmark(cfg, p, eval_fn, charset, device,
                                                     accuracy_fn)) for p in paths]
        total = sum(r["n"] for r in results)
        avg = sum(r["acc"] * r["n"] for r in results) / max(total, 1)
        print(f"average word accuracy over {len(results)} benchmarks: {avg:.4f}")
        if cfg.output_dir and is_main_process():
            with open(os.path.join(cfg.output_dir, "eval_results.json"), "w") as f:
                json.dump({"benchmarks": results, "average_acc": avg, "n_images": int(total),
                           "beam_width": cfg.beam_width}, f, indent=2)
        return results
    guard = PreemptionGuard.install()
    try:
        return _train(cfg, dist_info, model, (eval_fn, accuracy_fn), charset, guard)
    finally:
        guard.uninstall()


def make_eval(cfg: FinetuneConfig, model, charset):
    """(eval step, accuracy function) of the model's kind: CTC scores the
    collapsed per-frame ids; the decoupled decoder's model also returns
    its presence logits."""
    if cfg.model_kind == "ctc":
        return make_ctc_eval_step(model), ctc_accuracy
    return make_eval_step(model, beam_width=cfg.beam_width, eos=charset.eos_id,
                          with_cls=isinstance(model, SeqClsRecModel)), word_accuracy


def make_step(cfg: FinetuneConfig, model, device):
    """The training step of the model's kind (`dig_tpu/cli/run_finetune.py:348-370`);
    distillation builds and loads its frozen teacher here."""
    if cfg.use_feat_distill:
        teacher = build_model(cfg, device, use_feat_distill=False)
        load_finetune_init(cfg, teacher, cfg.teacher_ckpt)
        teacher.requires_grad_(False)
        return make_distill_finetune_step(model, teacher, smoothing=cfg.smoothing,
                                          loss_weight_feat_distill=cfg.loss_weight_feat_distill)
    if cfg.model_kind == "ctc":
        return make_ctc_step(model, blank_id=cfg.nb_classes)
    if cfg.model_kind == "mim_rec":
        return make_mim_finetune_step(
            model, smoothing=cfg.smoothing, mask_ratio=cfg.mask_ratio,
            mim_sample_ratio=cfg.mim_sample_ratio, loss_weight_pixel=cfg.loss_weight_pixel,
            normalize_target=cfg.normlize_target)
    return make_finetune_step(model, smoothing=cfg.smoothing)


def _train(cfg: FinetuneConfig, dist_info: dict, model, evaluation, charset, guard):
    eval_fn, accuracy_fn = evaluation
    device, rank, world = dist_info["device"], dist_info["rank"], dist_info["world_size"]
    device_abi = cfg.device_abi_aug and cfg.use_abi_aug
    train_ds = build_dataset(
        cfg.data_path, is_train=True, voc_type=cfg.voc_type, max_len=cfg.max_len,
        num_samples=cfg.num_samples, use_aug=cfg.num_view > 1 and not device_abi,
        use_abi_aug=cfg.use_abi_aug, img_height=cfg.input_h, img_width=cfg.input_w,
        rng=np.random.default_rng(cfg.seed + rank))
    loader = make_train_loader(
        train_ds, local_batch=local_batch(cfg.batch_size), rank=rank, world=world,
        seed=cfg.seed, num_workers=cfg.num_workers, worker_type=cfg.worker_type,
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
    broadcast_module(model)  # every rank starts from rank 0's weights

    step_fn = make_step(cfg, model, device)
    aug_fn = None
    if device_abi:
        def aug_fn(generator, images):  # uint8 transport: normalize before the [-1, 1] ops
            return device_abi_augment(generator, to_model_images(images))

    tb = TensorboardLogger(cfg.log_dir or os.path.join(cfg.output_dir, "tb"))
    jsonl = JsonlLogger(cfg.output_dir)
    tracer = StepTraceWindow(os.path.join(cfg.output_dir, "profile"),
                             cfg.profile_steps if rank == 0 else 0, cfg.profile_start_step)
    max_accuracy = 0.0

    def to_device(item):
        images, targets, lens = item
        return pinned_to_device({"images": images, "targets": targets, "lengths": lens}, device)

    def eval_and_keep_best(epoch):
        nonlocal max_accuracy
        stats = evaluate_benchmark(cfg, cfg.eval_data_path, eval_fn, charset, device,
                                   accuracy_fn)
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
                batch["images"] = aug_fn(step_generator(cfg.seed + 1, 1, gstep, device, rank),
                                         batch["images"])
            state, metrics, pred_ids = step_fn(
                state, batch, step_generator(cfg.seed + 1, 0, gstep, device, rank))
            tracer.tick()
            if guard.sync_should_stop(step=it, every=STOP_POLL_STEPS):
                # extra epoch - 1: auto-resume redoes this epoch's data with
                # the mid-epoch optimizer state
                tracer.close()
                guard.checkpoint_and_exit(cfg.output_dir, lambda: save_checkpoint(
                    cfg.output_dir, epoch, state, extra={"epoch": epoch - 1}),
                    f"epoch {epoch} step {it}")
            # the metrics stay on the device but for these steps
            if it % PRINT_FREQ == 0 or it == steps_per_epoch - 1:
                class_acc = accuracy_fn(
                    pred_ids.cpu().numpy(), batch["targets"].cpu().numpy(), charset)
                host_metrics = mean_over_ranks(dict(metrics, class_acc=class_acc))
                if not math.isfinite(host_metrics["loss"]):
                    print(f"Loss is {host_metrics['loss']}, stopping training")
                    sys.exit(1)
                logger.update(**host_metrics)
                tb.update(head="loss", step=int(state.step), **host_metrics)
            if cfg.eval_freq and it >= 1 and it % cfg.eval_freq == 0 and cfg.eval_data_path:
                eval_and_keep_best(epoch)
        logger.synchronize_between_processes()
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
