"""One gloo rank of tests/test_torch_port_dist.py, on the CPU.

    python tests/_torch_port_dist_worker.py <scenario> <dir> <rank> <world> <init_method>

Reads ``<dir>/inputs.pt`` (written by the test), joins a process group of
`world` gloo ranks at <init_method> (tests/_torch_port_ranks.py gives a
`file://` store), runs the scenario and writes
``<dir>/rank<rank>.pt``.  Scenarios:

* ``steps``: one pre-training step, one fine-tuning step (AdamW, and
  LAMB), two fine-tuning micro-steps under `update_freq` 2, `BatchStatsNorm` and InfoNCE forward
  and backward, each on this rank's rows of a global batch; the metric
  meters' sync, the preemption consensus (rank 1 signals itself) and the
  rank's step streams.
* ``cli``: `run_pretrain.main` for an epoch, again through
  `run_pretrain_multihost.main` to auto-resume, then
  `run_finetune.main` for an epoch with `--dist_eval` and an `--eval` run
  with `--dist_eval`.

Imports neither jax nor dig_tpu: the port's side only.
"""

import multiprocessing
import multiprocessing.forkserver
import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.modules["tensorflow"] = None  # TensorBoard scalars off: its import alone takes seconds

import torch  # noqa: E402

from dig_tpu_torch.parallel.dist import destroy, init_distributed_mode  # noqa: E402


def _rows(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _pretrain_step(inp, rank, world):
    from dig_tpu_torch.models.moco import DiGPretrainModel
    from dig_tpu_torch.optim import AdamW
    from dig_tpu_torch.train.pretrain import make_pretrain_step
    from dig_tpu_torch.train.state import TrainState

    p = inp["pretrain"]
    model = DiGPretrainModel(**p["cfg"])
    model.load_state_dict(p["state_dict"])
    opt = AdamW(model.named_parameters(), p["lr"], p["wd"], eps=p["eps"])
    state = TrainState(model=model, optimizer=opt)
    step = make_pretrain_step(model, p["mom"], p["cw"])
    batch = {k: _rows(v, rank, world) for k, v in p["batch"].items()}
    state, metrics = step(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: q.grad.clone() for n, q in model.named_parameters() if q.requires_grad},
            "params": {k: v.clone() for k, v in model.state_dict().items()}}


def _finetune(inp, rank, world, update_freq, opt_name="adamw"):
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.optim import create_optimizer, frozen_encoder_mask
    from dig_tpu_torch.train.finetune import init_finetune_state, make_finetune_step

    f = inp["finetune"]
    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    for m in model.decoder.modules():  # decoder dropout 0, as the test's one process
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    model.load_state_dict(f["state_dict"])
    opt = create_optimizer(opt_name, model.named_parameters(), f["lr"], f["wd"], eps=f["eps"],
                           clip_grad=f["clip"][update_freq], layer_decay=f["layer_decay"],
                           num_layers=2, frozen=frozen_encoder_mask(f["frozen"]),
                           update_freq=update_freq)
    state = init_finetune_state(model, opt)
    step = make_finetune_step(model, smoothing=f["smoothing"])
    out = {"metrics": [], "reduced": []}
    names = [n for n, q in model.named_parameters() if q.requires_grad]
    real_reduce = opt.reducer.reduce

    def reduce(grads):  # what the reducer hands the optimizer, before clipping
        reduced = real_reduce(grads)
        out["reduced"].append({n: g.clone() for n, g in zip(names, reduced)})
        return reduced

    opt.reducer.reduce = reduce
    for batch in f["batches"][:update_freq]:
        state, metrics, _ = step(state, {k: _rows(v, rank, world) for k, v in batch.items()},
                                 torch.Generator().manual_seed(0))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    if update_freq == 1:
        out["grads"] = {n: q.grad.clone() for n, q in model.named_parameters()}
    out["params"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["count"] = opt.count
    return out


def _norm_and_infonce(inp, rank, world):
    from dig_tpu_torch.losses.infonce import info_nce_loss
    from dig_tpu_torch.models.moco import BatchStatsNorm

    h = inp["heads"]
    out = {}
    for name, x in h["bn_inputs"].items():
        bn = BatchStatsNorm(x.shape[-1])
        bn.load_state_dict(h["bn_state"])
        xl = _rows(x, rank, world).clone().requires_grad_(True)
        y = bn(xl)
        (y * _rows(h["bn_dy"][name], rank, world)).sum().backward()
        out[f"bn_{name}"] = {"y": y.detach(), "dx": xl.grad, "dweight": bn.weight.grad,
                             "dbias": bn.bias.grad}
    q = _rows(h["q"], rank, world).clone().requires_grad_(True)
    loss, (acc1, acc5) = info_nce_loss(q, _rows(h["k"], rank, world), h["t"], h["smoothing"],
                                       return_acc=True)
    loss.backward()
    out["infonce"] = {"loss": float(loss), "acc1": float(acc1), "acc5": float(acc5),
                      "dq": q.grad}
    return out


def _sync_and_streams(rank, world):
    from dig_tpu_torch.utils.metric_logger import MetricLogger
    from dig_tpu_torch.utils.preemption import PreemptionGuard
    from dig_tpu_torch.utils.rng import step_generator

    logger = MetricLogger()
    for i in range(3 + rank):  # the ranks log different numbers of values
        logger.update(loss=10.0 * rank + i)
    logger.meters["loss"].update(0.5, n=4 + rank)
    logger.synchronize_between_processes()
    m = logger.meters["loss"]

    guard = PreemptionGuard.install()
    stop_at = None
    try:
        for it in range(12):
            if rank == 1 and it == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            if guard.sync_should_stop(step=it, every=3):
                stop_at = it
                break
        local_flag = guard.should_stop
    finally:
        guard.uninstall()
    draws = {stream: torch.rand(8, generator=step_generator(7, stream, 5, "cpu", rank))
             for stream in (0, 1)}
    return {"meter": (m.count, m.total, m.global_avg), "stop_at": stop_at,
            "local_flag": local_flag, "draws": draws}


def _steps(inp, rank, world):
    out = {"pretrain": _pretrain_step(inp, rank, world),
           "finetune": _finetune(inp, rank, world, 1),
           "finetune_update_freq_2": _finetune(inp, rank, world, 2),
           "finetune_lamb": _finetune(inp, rank, world, 1, "lamb")}
    out.update(_norm_and_infonce(inp, rank, world))
    out.update(_sync_and_streams(rank, world))
    return out


def _cli(inp, rank, world):
    from dig_tpu_torch.cli import run_finetune, run_pretrain, run_pretrain_multihost
    from dig_tpu_torch.config import FinetuneConfig, PretrainConfig, parse_config
    from dig_tpu_torch.utils import checkpoint as ckpt

    restored = []
    real_restore = ckpt.restore_checkpoint

    def restore(path):
        restored.append(os.path.abspath(path))
        return real_restore(path)

    ckpt.restore_checkpoint = restore
    pre = parse_config(PretrainConfig, inp["pretrain_argv"])
    first = run_pretrain.main(pre, device="cpu")
    out = {"pretrain": {k: v.clone() for k, v in first.model.state_dict().items()},
           "pretrain_step": first.step,
           # the run's process workers (--worker_type process) and their
           # server, which main stops on every rank
           "left_running": [p.name for p in multiprocessing.active_children()],
           "forkserver": multiprocessing.forkserver._forkserver._forkserver_pid}
    # again, through the multi-host launcher, which joins this group: it
    # auto-resumes the last checkpoint and trains nothing more
    again = run_pretrain_multihost.main(pre, device="cpu")
    out["resumed_from"] = list(restored)
    out["resumed"] = {k: v.clone() for k, v in again.model.state_dict().items()}
    out["resumed_step"] = again.step
    ft = run_finetune.main(parse_config(FinetuneConfig, inp["finetune_argv"]), device="cpu")
    out["finetune"] = {k: v.clone() for k, v in ft.model.state_dict().items()}
    out["finetune_step"] = ft.step
    out["eval"] = run_finetune.main(parse_config(FinetuneConfig, inp["eval_argv"]),
                                    device="cpu")
    return out


def main(scenario, root, rank, world, init_method):
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    info = init_distributed_mode("cpu", rank=rank, world_size=world, init_method=init_method)
    assert info["backend"] == "gloo" and info["created"], info
    try:
        out = {"steps": _steps, "cli": _cli}[scenario](inp, rank, world)
    finally:
        destroy()
    out["info"] = {k: str(v) for k, v in info.items()}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
