"""One gloo rank of tests/test_torch_port_sharded_steps.py, on the CPU.

    python tests/_torch_port_sharded_worker.py <DxFxT> <dir> <rank> <world> <init_method>

Reads ``<dir>/inputs.pt`` (written by the test), joins a process group of
`world` gloo ranks at <init_method> (none at world 1: the
one-process reference), lays them out as the mesh D x F x T
(`parallel.mesh.create_mesh`), shards the models by the JAX package's rules
(every >= 2-D leaf, ``min_size`` 1, so that FSDP covers the micro width)
and writes ``<dir>/rank<rank>.pt``.  Each rank loads its rows of the
global batch (rank r's share, as its loader would give it); `shard_batch`
gathers its tensor peers'.  In float64:

* ``pretrain`` / ``finetune``: `STEPS` steps of AdamW with clipping, the
  losses and norms of each step, the whole parameters after;
* ``heads3`` (tensor peers only): a pre-training step of an encoder of 3
  heads, which 2 tensor ranks do not divide (the gathered path);
* ``lamb``, ``update_freq_2``, ``remat`` (D x 2 x 1 only): one update each;
  ``adamp``, ``novograd``, ``adafactor`` (D x 2 x 1 and 1 x 1 x 2): one
  fine-tuning update each, their row norms, norms and factored moments
  over the whole tensors;
* ``dropout`` (tensor peers only): one fine-tuning step and one
  pre-training step with dropout and drop-path on; each rank's own
  replicated leaves, which tensor peers must hold bit-equal;
* ``resume``: the one-process checkpoint of ``<dir>/ckpt`` restored into
  this mesh, saved again (the whole tensors, `full_state_dict`), then one
  more step;
* ``divisor``: the data-parallel divisor of each `GradientReducer`.

With ``cli`` for the mesh, started by torchrun (rank, world and
rendezvous in its variables; the arguments' are ignored), the ranks run
the training CLIs' `main` instead, on the CPU over gloo, for each (kind,
argv) of ``inputs.pt``'s "runs" (the flags name the mesh), and save each
run's step count.

Imports neither jax nor dig_tpu: the port's side only.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dig_tpu_torch.parallel.dist import destroy, init_distributed_mode  # noqa: E402

F64 = torch.float64
STEPS = 3
# a pre-training model of one block at the micro width (2 heads of 32)
PRE_CFG = dict(img_size=(32, 128), patch_size=4, encoder_embed_dim=64, encoder_depth=1,
               encoder_num_heads=2, decoder_num_classes=48, decoder_embed_dim=64, mlp_ratio=4.0,
               qkv_bias=True, mlp_dim=32, dim=16, temperature=0.2, num_windows=4)
HEADS3_CFG = dict(PRE_CFG, encoder_embed_dim=96, encoder_num_heads=3)
PRE_BATCH, FT_BATCH = 8, 4
CLIP, OPT_EPS, SMOOTHING = 3.0, 1e-3, 0.1
RATES = 0.1  # dropout, attention dropout and drop-path of the ``dropout`` scenario
OPTIMIZERS = ("adamp", "novograd", "adafactor")


def rows(x, rank, world):
    """Rank `rank`'s share of a global batch, as its loader gives it."""
    x = torch.as_tensor(np.asarray(x))
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def pretrain_model(cfg, state_dict, **kw):
    from dig_tpu_torch.models.moco import DiGPretrainModel

    model = DiGPretrainModel(**cfg, dtype=F64, **kw).to(F64)
    model.load_state_dict(state_dict)
    return model


def rec_model(state_dict, rates=0.0):
    from dig_tpu_torch.models.rec_model import build_rec_model

    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", drop_rate=rates,
                            attn_drop_rate=rates, drop_path_rate=rates, dtype=F64, device="cpu")
    if rates == 0.0:
        for m in model.decoder.modules():  # the counterpart of decoder.clone(dropout=0.0)
            if hasattr(m, "dropout"):
                m.dropout = 0.0
    model = model.to(F64)
    model.load_state_dict(state_dict)
    return model


def _optimizer(model, sched, name="adamw", update_freq=1, **kw):
    from dig_tpu_torch.optim import create_optimizer

    return create_optimizer(name, model.named_parameters(), sched["lr"], sched["wd"], eps=OPT_EPS,
                            clip_grad=CLIP, update_freq=update_freq, **kw)


def _replicated(model):
    """This rank's replicated parameters (no shard spec), as they are."""
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if getattr(p, "shard_spec", None) is None}


def run_pretrain(inp, mesh, batches, cfg=PRE_CFG, state_dict=None, opt="adamw",
                 update_freq=1, gen_seed=None, **model_kw):
    """Pre-training steps on `batches` (global): per-step metrics, the whole
    parameters after, this rank's replicated leaves and the model."""
    from dig_tpu_torch.parallel.mesh import shard_batch
    from dig_tpu_torch.parallel.sharding import full_state_dict, shard_model
    from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
    from dig_tpu_torch.utils.rng import step_generator

    p = inp["pretrain"]
    model = pretrain_model(cfg, p["state_dict"] if state_dict is None else state_dict,
                           **model_kw)
    shard_model(model, mesh, min_size=1)
    state = init_pretrain_state(model, _optimizer(model, p["sched"], opt, update_freq))
    step = make_pretrain_step(model, p["mom"], p["cw"])
    metrics = []
    for i, batch in enumerate(batches):
        local = shard_batch({k: rows(v, mesh.rank, mesh.world) for k, v in batch.items()})
        gen = None if gen_seed is None else step_generator(gen_seed, 0, i, "cpu", mesh.dp_index)
        state, m = step(state, local, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": full_state_dict(model),
            "replicated": _replicated(model)}, state


def run_finetune(inp, mesh, batches, opt="adamw", update_freq=1, rates=0.0, gen_seed=0):
    from dig_tpu_torch.parallel.mesh import shard_batch
    from dig_tpu_torch.parallel.sharding import full_state_dict, shard_model
    from dig_tpu_torch.train.finetune import init_finetune_state, make_finetune_step
    from dig_tpu_torch.utils.rng import step_generator

    f = inp["finetune"]
    model = rec_model(f["state_dict"], rates)
    shard_model(model, mesh, min_size=1)
    state = init_finetune_state(model, _optimizer(model, f["sched"], opt, update_freq))
    step = make_finetune_step(model, smoothing=SMOOTHING)
    metrics = []
    for i, batch in enumerate(batches):
        local = shard_batch({k: rows(v, mesh.rank, mesh.world) for k, v in batch.items()})
        state, m, _ = step(state, local, step_generator(gen_seed, 0, i, "cpu", mesh.dp_index))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": full_state_dict(model), "count": state.optimizer.count,
            "replicated": _replicated(model)}


def _resume(inp, mesh, root):
    """The one-process checkpoint restored into this mesh, saved whole again,
    then one more pre-training step from it."""
    from dig_tpu_torch.parallel.mesh import shard_batch
    from dig_tpu_torch.parallel.sharding import full_state_dict, shard_model
    from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
    from dig_tpu_torch.utils.checkpoint import load_into_state, restore_checkpoint, save_checkpoint

    p = inp["pretrain"]
    model = pretrain_model(PRE_CFG, p["state_dict"])
    shard_model(model, mesh, min_size=1)
    state = init_pretrain_state(model, _optimizer(model, p["sched"]))
    load_into_state(state, restore_checkpoint(os.path.join(root, "ckpt", "checkpoint-0")))
    path = save_checkpoint(os.path.join(root, f"resaved_{mesh.n_data}x{mesh.n_fsdp}x"
                                              f"{mesh.n_tensor}"), 0, state)
    step = make_pretrain_step(model, p["mom"], p["cw"])
    batch = p["batches"][state.step]
    state, m = step(state, shard_batch({k: rows(v, mesh.rank, mesh.world)
                                        for k, v in batch.items()}))
    return {"path": path, "metrics": {k: float(v) for k, v in m.items()},
            "params": full_state_dict(model)}


def _divisors(inp, mesh):
    from dig_tpu_torch.parallel.sharding import shard_model

    model = rec_model(inp["finetune"]["state_dict"])
    shard_model(model, mesh, min_size=1)
    reducer = _optimizer(model, inp["finetune"]["sched"]).reducer
    if reducer is None:  # one process: nothing to reduce
        return []
    parts = getattr(reducer, "parts", None) or [(None, reducer)]
    return [r.divisor for _, r in parts]


def scenarios(inp, mesh, root):
    p, f = inp["pretrain"], inp["finetune"]
    out = {}
    out["pretrain"], _ = run_pretrain(inp, mesh, p["batches"])
    out["finetune"] = run_finetune(inp, mesh, f["batches"])
    out["resume"] = _resume(inp, mesh, root)
    out["divisors"] = _divisors(inp, mesh)
    if mesh.n_tensor > 1 or mesh.world == 1:
        out["heads3"], _ = run_pretrain(inp, mesh, p["batches"][:1], HEADS3_CFG,
                                        inp["heads3_state_dict"])
    if mesh.n_tensor > 1:
        out["dropout_finetune"] = run_finetune(inp, mesh, f["batches"][:1], rates=RATES,
                                               gen_seed=5)
        out["dropout_pretrain"], _ = run_pretrain(inp, mesh, p["batches"][:1], gen_seed=5,
                                                  drop_path_rate=RATES)
    fsdp_only = mesh.n_fsdp > 1 and mesh.n_tensor == 1
    if fsdp_only or mesh.world == 1:
        out["lamb"] = run_finetune(inp, mesh, f["batches"][:1], opt="lamb")
        out["update_freq_2"] = run_finetune(inp, mesh, f["batches"][:2], update_freq=2)
        out["remat"], _ = run_pretrain(inp, mesh, p["batches"][:1], remat=True)
    if fsdp_only or (mesh.n_data, mesh.n_fsdp, mesh.n_tensor) == (1, 1, 2) or mesh.world == 1:
        for name in OPTIMIZERS:
            out[name] = run_finetune(inp, mesh, f["batches"][:1], opt=name)
    return out


def run_clis(inp):
    from dig_tpu_torch.cli import run_finetune, run_pretrain
    from dig_tpu_torch.config import FinetuneConfig, PretrainConfig, parse_config

    steps = []
    for kind, argv in inp["runs"]:
        cli, cfg = ((run_pretrain, PretrainConfig) if kind == "pretrain"
                    else (run_finetune, FinetuneConfig))
        steps.append(cli.main(parse_config(cfg, argv), device="cpu").step)
    return {"steps": steps}


def main(spec, root, rank, world, init_method):
    from dig_tpu_torch.parallel.mesh import clear_mesh, create_mesh

    torch.set_num_threads(1)
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    if spec == "cli":
        sys.modules["tensorflow"] = None  # TensorBoard scalars off: its import alone takes seconds
        rank = init_distributed_mode("cpu")["rank"]  # torchrun's variables
        try:
            out = run_clis(inp)
        finally:
            destroy()
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        return
    n_data, n_fsdp, n_tensor = (int(a) for a in spec.split("x"))
    info = None
    if world > 1:
        info = init_distributed_mode("cpu", rank=rank, world_size=world, init_method=init_method)
        assert info["backend"] == "gloo" and info["created"], info
    try:
        mesh = create_mesh(n_fsdp, n_tensor, n_data)
        out = scenarios(inp, mesh, root)
        out["coords"] = (mesh.data, mesh.fsdp, mesh.tensor)
    finally:
        clear_mesh()
        if info is not None:
            destroy()
    if rank != 0:  # the whole tensors are the same on every rank: keep rank 0's
        for v in out.values():
            if isinstance(v, dict):
                v.pop("params", None)
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
