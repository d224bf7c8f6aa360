"""Pre-training entry point (MoCo-v3 + SimMIM joint SSL), on the card.

    python -m dig_tpu_torch.cli.run_pretrain \
        --batch_size 128 --epochs 10 --warmup_steps 5000 \
        --model pretrain_simmim_moco_ori_vit_small_patch4_32x128 \
        --mask_ratio 0.7 --moco_t 0.2 --num_windows 4 \
        --loss_weight_pixel 1. --loss_weight_contrast 0.1 \
        --image_alone_path /path/to/lmdb ...

Counterpart of `dig_tpu.cli.run_pretrain`, with the same flags and the
same order of work: LMDB -> dataset -> host SeqCLR
augmentation on the loader's workers (or, under `--device_aug`, the view
generator on the model's device) -> loader with device prefetch -> the
pre-training step -> metric log -> checkpoint -> resume.  Outputs under
`--output_dir`: ``checkpoint-{epoch}/{checkpoint.pth,meta.json}``
(`utils/checkpoint.py`), ``log.txt`` (one JSON line an epoch),
``screen.txt`` (stdout's copy), ``tb/`` and, with `--profile_steps`, a
trace of a window of steps (``profile/trace.json``, `utils/profiling.py`).
SIGTERM / SIGINT checkpoint at the next step boundary and exit 0 (143
without an `--output_dir`; `utils/preemption.py`), as in the JAX CLI.

Every random draw of a step comes from a generator seeded with (seed,
stream, global step, rank) (`utils/rng.py`), so with `--device_aug` a
resumed run repeats an uninterrupted one.

Data parallel, one process per card over NCCL:

    torchrun --nproc_per_node 8 -m dig_tpu_torch.cli.run_pretrain ...

Each rank runs the step on its own `--batch_size` rows of the epoch
(`ShardedSampler`); the keys of InfoNCE are gathered from every rank, the
heads' batch statistics are the global batch's and the gradients are
averaged over the ranks before clipping (`parallel/dist.py`), so N ranks
train as one process would on the global batch of N x `--batch_size`
(the lr scales with it, `cfg.finalize(world)`).  Ranks draw their own
dropout, masks and views; rank 0's draws are the single process's.  Only
rank 0 prints, writes ``log.txt``, ``screen.txt``, TensorBoard scalars, the
trace and checkpoints; every rank resumes from the same checkpoint.  A
signal that reaches any rank stops every rank at the same step boundary
(polled every `STOP_POLL_STEPS` steps).  `main` finds its rank from
torchrun's variables (`parallel.dist.init_distributed_mode`), or joins a
process group its caller made.

Runs on CUDA; `main(cfg, device="cpu")` runs the plain versions of the
kernels (and, across processes, over gloo).  Process workers
(`--worker_type process`) and their server are stopped when `main` ends,
on every rank.  stdout is teed into ``screen.txt``, and the signal
handlers are installed, only while `main` runs: both are put back when it
returns or raises (the JAX CLI leaves them installed).

Parameter sharding, as in the JAX CLI:

    torchrun --nproc_per_node 4 -m dig_tpu_torch.cli.run_pretrain --n_fsdp 2 --n_tensor 2 ...

lays the world's ranks out as a (data, fsdp, tensor) mesh
(`parallel/mesh.py`; a mesh that does not divide the world is refused
before anything is written) and shards the parameters, the momentum branch
and the optimizer state by the JAX package's rules (`parallel/sharding.py`):
the ViT blocks split their heads and columns over ``tensor``, and the
large leaves are split over ``fsdp``.  Tensor peers compute on the rows of
their whole group (`shard_batch`) and draw the same dropout (stream 0 is
keyed by the data-parallel index); each rank still loads `--batch_size`
rows, the global batch is `--batch_size` x world.  Checkpoints hold the
whole tensors whatever the mesh, so a run resumes across meshes.

Every `--opt` of `dig_tpu` (`optim.py`), `--remat` (each encoder block
rematerialized in the backward), `--patchnet_name conv` (`ConvPatchNet`),
`--resume` of a native `dig_tpu` checkpoint directory (params, momentum
branch and AdamW's moments; another optimizer's state is refused) and
remote checkpoint URIs (`--resume`, `--output_dir`'s checkpoints; through
fsspec, which must be installed for them) run here.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from dig_tpu_torch.config import PretrainConfig, config_to_json, parse_config
from dig_tpu_torch.data.dataset import build_pretraining_dataset
from dig_tpu_torch.data.pipeline import (
    device_prefetch,
    make_train_loader,
    pinned_to_device,
    stop_worker_processes,
)
from dig_tpu_torch.models.moco import build_pretrain_model
from dig_tpu_torch.optim import create_optimizer, parse_optimizer_name
from dig_tpu_torch.parallel.dist import (
    broadcast_module,
    destroy,
    init_distributed_mode,
    mean_over_ranks,
)
from dig_tpu_torch.parallel.mesh import clear_mesh, create_mesh, local_batch, shard_batch
from dig_tpu_torch.parallel.sharding import full_numel, shard_model
from dig_tpu_torch.train.pretrain import (
    init_pretrain_state,
    make_device_view_fn,
    make_pretrain_step,
)
from dig_tpu_torch.utils.checkpoint import (
    auto_resume,
    load_into_state,
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
from dig_tpu_torch.utils.schedules import (
    contrast_weight_schedule,
    cosine_schedule,
    moco_momentum_schedule,
)

PRINT_FREQ = 100  # steps between reads of the metrics to the host


def build_model(cfg: PretrainConfig, device):
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return build_pretrain_model(
        cfg.model, dtype=dtype, seed=cfg.seed, device=device,
        mlp_dim=cfg.moco_mlp_dim, dim=cfg.moco_dim, temperature=cfg.moco_t,
        num_windows=cfg.num_windows, patchnet_name=cfg.patchnet_name,
        label_smoothing=cfg.label_smoothing, drop_path_rate=cfg.drop_path, remat=cfg.remat)


def main(cfg: PretrainConfig, device="cuda"):
    parse_optimizer_name(cfg.opt)  # a name dig_tpu does not know: before anything is built
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_pretrain runs on CUDA and no card is visible; "
                           "call main(cfg, device='cpu') for the CPU")
    dist_info = init_distributed_mode(device)
    tee = None
    try:
        # a mesh the world does not divide raises here, before anything is written
        dist_info["mesh"] = create_mesh(cfg.n_fsdp, cfg.n_tensor)
        with stdout_on_main_process_only():
            if cfg.output_dir and is_main_process():
                os.makedirs(cfg.output_dir, exist_ok=True)
                tee = ScreenTee(cfg.output_dir).install()
            guard = PreemptionGuard.install()
            try:
                return _run(cfg, dist_info, guard)
            finally:
                guard.uninstall()
                if tee is not None:
                    tee.close()
    finally:
        if cfg.worker_type == "process":  # this rank's loader workers and their server
            stop_worker_processes()
        clear_mesh()
        if dist_info["created"]:
            destroy()


def _run(cfg: PretrainConfig, dist_info: dict, guard):
    print(config_to_json(cfg))
    device, rank, world = dist_info["device"], dist_info["rank"], dist_info["world_size"]
    mesh = dist_info["mesh"]
    cfg.finalize(world)
    backend = f", {dist_info['backend']}" if dist_info["backend"] else ""
    print(f"devices: {world} ({device}{backend}), mesh: {mesh.shape}, lr: {cfg.absolute_lr:.2e}")

    rng = np.random.default_rng(cfg.seed + rank)
    dataset = build_pretraining_dataset(
        cfg.image_alone_path,
        mask_ratio=cfg.mask_ratio,
        num_view=1 if cfg.device_aug else cfg.num_view,
        num_samples=cfg.aloneimage_num_samples,
        max_len=cfg.max_len,
        img_height=cfg.input_h,
        img_width=cfg.input_w,
        window_size=cfg.window_size,
        rng=rng,
    )
    loader = make_train_loader(
        dataset, local_batch=local_batch(cfg.batch_size), rank=rank, world=world,
        seed=cfg.seed, num_workers=cfg.num_workers,
        worker_type=cfg.worker_type,
        batch_wise_shuffle=cfg.batch_wise_shuffle)
    steps_per_epoch = len(loader)
    print(f"dataset: {len(dataset)} imgs, {steps_per_epoch} steps/epoch")

    lr_sched = cosine_schedule(
        cfg.absolute_lr, cfg.min_lr, cfg.epochs, steps_per_epoch,
        warmup_epochs=cfg.warmup_epochs, start_warmup_value=cfg.warmup_lr,
        warmup_steps=cfg.warmup_steps,
    )
    wd_sched = cosine_schedule(cfg.weight_decay, cfg.weight_decay_end,
                               cfg.epochs, steps_per_epoch)
    mom_sched = moco_momentum_schedule(cfg.moco_m, cfg.epochs, steps_per_epoch,
                                       use_cosine=cfg.use_moco_m_cos)
    cw_sched = contrast_weight_schedule(
        cfg.loss_weight_contrast, cfg.epochs, steps_per_epoch,
        start_epoch=cfg.contrast_start_epoch, warmup_steps=cfg.contrast_warmup_steps,
    )

    model = build_model(cfg, device)
    broadcast_module(model)  # every rank starts from rank 0's weights
    shard_model(model, mesh)  # this rank's pieces of the sharded parameters
    optimizer = create_optimizer(
        cfg.opt, model.named_parameters(), lr_sched, wd_sched, betas=cfg.opt_betas,
        eps=cfg.opt_eps, clip_grad=cfg.clip_grad,
    )
    state = init_pretrain_state(model, optimizer)
    n_params = sum(full_numel(p) for p in model.parameters() if p.requires_grad)
    print(f"params: {n_params / 1e6:.2f} M")

    # restore after init_pretrain_state, which resets the momentum branch
    start_epoch = cfg.start_epoch
    if cfg.resume:
        payload = restore_checkpoint(cfg.resume)
        load_into_state(state, payload)
        start_epoch = int(payload.get("extra", {}).get("epoch", -1)) + 1
    elif cfg.auto_resume and cfg.output_dir:
        state, extra = auto_resume(cfg.output_dir, state)
        if extra is not None:
            start_epoch = int(extra.get("epoch", -1)) + 1

    step_fn = make_pretrain_step(
        model, mom_sched, cw_sched,
        loss_weight_pixel=cfg.loss_weight_pixel,
        only_mim_on_ori_img=cfg.only_mim_on_ori_img,
        normalize_target=cfg.normlize_target,
    )
    view_fn = None
    if cfg.device_aug:
        view_fn = make_device_view_fn(model.num_patches, cfg.mask_ratio, cfg.num_view)

    tb = TensorboardLogger(cfg.log_dir or os.path.join(cfg.output_dir, "tb"))
    jsonl = JsonlLogger(cfg.output_dir)
    tracer = StepTraceWindow(os.path.join(cfg.output_dir, "profile"),
                             cfg.profile_steps if rank == 0 else 0, cfg.profile_start_step)

    def to_device(item):
        ori, aug, mask = item
        if view_fn is not None:
            return pinned_to_device({"images": ori}, device)
        return pinned_to_device({"images": ori, "aug_images": aug, "mask": mask}, device)

    for epoch in range(start_epoch, cfg.epochs):
        loader.sampler.set_epoch(epoch)
        logger = MetricLogger()
        header = f"Epoch: [{epoch}]"
        batches = device_prefetch(iter(loader), to_device)
        for it, batch in enumerate(
            logger.log_every(batches, PRINT_FREQ, header, total=steps_per_epoch)
        ):
            # one generator a step and a stream, from (seed, stream, global
            # step, rank) alone: 0 the train step (keyed by the data-parallel
            # index: tensor peers draw the same masks), 1 the view generator
            # (by the rank, on this rank's rows)
            gstep = epoch * steps_per_epoch + it
            if view_fn is not None:
                batch = view_fn(step_generator(cfg.seed + 1, 1, gstep, device, rank),
                                batch["images"])
            state, metrics = step_fn(
                state, shard_batch(batch),
                step_generator(cfg.seed + 1, 0, gstep, device, mesh.dp_index))
            tracer.tick()
            if guard.sync_should_stop(step=it, every=STOP_POLL_STEPS):
                # extra epoch - 1: auto-resume redoes this epoch (with
                # --device_aug, the same batches)
                tracer.close()
                guard.checkpoint_and_exit(cfg.output_dir, lambda: save_checkpoint(
                    cfg.output_dir, epoch, state, extra={"epoch": epoch - 1}),
                    f"epoch {epoch} step {it}")
            # the metrics stay on the device but for these steps: reading a
            # scalar waits for the card, and a wait a step would stall it
            if it % PRINT_FREQ == 0 or it == steps_per_epoch - 1:
                host_metrics = mean_over_ranks(metrics)
                if not math.isfinite(host_metrics["loss"]):
                    print(f"Loss is {host_metrics['loss']}, stopping training")
                    sys.exit(1)
                logger.update(**host_metrics)
                tb.update(head="loss", step=int(state.step), **host_metrics)
            if cfg.eval_freq and it >= 1 and it % (cfg.eval_freq * 10) == 0:
                save_checkpoint(cfg.output_dir, f"{epoch}_{it}", state,
                                extra={"epoch": epoch})
        logger.synchronize_between_processes()
        print("Averaged stats:", logger)
        if cfg.output_dir and (
            (epoch + 1) % cfg.save_ckpt_freq == 0 or epoch + 1 == cfg.epochs
        ):
            save_checkpoint(cfg.output_dir, epoch, state, extra={"epoch": epoch})
            if cfg.keep_ckpt_max > 0:
                prune_checkpoints(cfg.output_dir, cfg.keep_ckpt_max)
        jsonl.write(
            epoch=epoch,
            **{f"train_{k}": m.global_avg for k, m in logger.meters.items()},
            n_parameters=int(n_params),
        )
    tracer.close()
    tb.flush()
    return state


if __name__ == "__main__":
    main(parse_config(PretrainConfig))
