"""Data-parallel training of the port, on the CPU over gloo: two ranks
against one process on the global batch, and against the JAX package's
step jitted over a 2-device CPU mesh (the conftest gives JAX 8 host
devices).

Each scenario launches its two ranks once, as subprocesses
(`tests/_torch_port_dist_worker.py`, through tests/_torch_port_ranks.py: a
free port, a time limit, one retry when gloo's rendezvous misses its own
deadline, as tests/test_multiprocess.py launches its hosts), and the tests
below read the results it saved:

* ``steps``: the pre-training step (2 ranks x 4 images against 8), the
  fine-tuning step (2 x 2 against 4) and two fine-tuning micro-steps under
  `update_freq` 2 with clipping, `BatchStatsNorm` and InfoNCE forward and
  backward, the metric meters' sync, the preemption consensus and the
  ranks' step streams;
* ``cli``: both CLIs for an epoch on a tiny LMDB at 2 ranks, an
  auto-resume, and `--dist_eval`.

JAX weights (initialized, perturbed) are carried to the port by the
existing converters; dropout, drop-path and the views are off or given as
inputs, since the two packages' random streams cannot match.  Everything
is fp32.  The two ranks sum in another order than one process (the keys'
gather, the statistics' sums, the gradients' sum and division): they are
held to one process at 1e-5 of each quantity's largest value.  Against
JAX the tolerances are those of the one-process parity tests
(tests/test_torch_port_{pretrain,finetune}.py), restated where used.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port_ranks as launch
from _torch_port_pretrain_step import check_relu_margin
from _torch_port_threads import one_thread
from dig_tpu.losses import infonce as jinfonce
from dig_tpu.models import moco as jmoco
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.optim import create_optimizer as j_create_optimizer
from dig_tpu.optim import frozen_encoder_mask as j_frozen_encoder_mask
from dig_tpu.optim import make_optimizer as j_make_optimizer
from dig_tpu.parallel.mesh import create_mesh, shard_batch
from dig_tpu.train.finetune import make_finetune_step as j_make_finetune_step
from dig_tpu.train.pretrain import make_pretrain_step as j_make_pretrain_step
from dig_tpu.train.state import TrainState as JTrainState
from dig_tpu_torch.losses.infonce import info_nce_loss
from dig_tpu_torch.models import moco as tmoco
from dig_tpu_torch.models.rec_model import build_rec_model
from dig_tpu_torch.optim import AdamW, create_optimizer, frozen_encoder_mask
from dig_tpu_torch.parallel import dist as tdist
from dig_tpu_torch.train.finetune import init_finetune_state, make_finetune_step
from dig_tpu_torch.train.pretrain import make_pretrain_step
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils.convert import moco_params_from_jax, params_from_jax
from dig_tpu_torch.utils.rng import step_generator


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


WORLD = 2
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_port_dist_worker.py")

# a pre-training model of one block, width 64 (the micro encoder's), and
# the fine-tuning recognizer vit_micro + small_tf_decoder
PRE_CFG = dict(img_size=(32, 128), patch_size=4, encoder_embed_dim=64, encoder_depth=1,
               encoder_num_heads=1, decoder_num_classes=48, decoder_embed_dim=64, mlp_ratio=4.0,
               qkv_bias=True, mlp_dim=32, dim=16, temperature=0.2, num_windows=4)
PRE_BATCH, FT_BATCH = 8, 4  # global batches: 4 and 2 rows a rank
LR, WD, MOM, CW, OPT_EPS = 1e-3, 0.05, 0.5, 0.1, 1e-3
LAYER_DECAY, FROZEN, SMOOTHING, CLIP = 0.75, 1, 0.1, 0.5
ONE_PROCESS_RTOL = 1e-5


def _start(scenario, root):
    return launch.start(scenario, root, WORLD, WORKER)


def _finish(scenario, root, procs):
    """Wait for the ranks (relaunching once after gloo's rendezvous flake)
    and load what each saved."""
    return launch.finish(scenario, root, procs, WORKER)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=np.shape(p)).astype(np.float32), tree)


def _grad_saver():
    """An optax transform that passes grads through and keeps them in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}))


def _close_to_max(got, want, rtol, atol=0.0, what=""):
    """max |got - want| within rtol of max |want| (plus atol)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale + atol, f"{what}: max abs err {err:.3e} vs max |want| {scale:.3e}"


def _mesh():
    return create_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])


def _rec_model():
    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    for m in model.decoder.modules():  # the counterpart of decoder.clone(dropout=0.0)
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    return model


# ---------------------------------------------------------------------------
# the steps scenario: inputs, the one-process port, the JAX mesh step
# ---------------------------------------------------------------------------

def _pretrain_inputs():
    jm = jmoco.DiGPretrainModel(**PRE_CFG)
    rng = np.random.default_rng(60)
    batch = {"images": rng.integers(0, 256, (PRE_BATCH, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (PRE_BATCH, 32, 128, 3), dtype=np.uint8),
             "mask": np.zeros((PRE_BATCH, 2, 256), bool)}
    for r in range(PRE_BATCH):
        for v in range(2):
            batch["mask"][r, v, rng.permutation(256)[:179]] = True
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2 * PRE_BATCH, 32, 128, 3)),
                        jnp.zeros((2 * PRE_BATCH, 256), bool), True)
    # a draw whose ReLU inputs sit off the kink (tests/_torch_port_pretrain_step.py)
    params = _perturb(variables["params"], 139)
    ema = _perturb({k: params[k] for k in jm.ema_submodules()}, 62)
    check_relu_margin(PRE_CFG, params, ema, batch)
    return jm, params, ema, batch


def _pretrain_jax_on_mesh(jm, params, ema, batch, lr, wd, mom, cw):
    tx = optax.chain(_grad_saver(), j_make_optimizer(lr, wd, eps=OPT_EPS))
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx,
                               ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    mesh = _mesh()
    step = j_make_pretrain_step(jm, mom, cw, mesh=mesh)
    new, metrics = step(state, shard_batch(mesh, batch), jax.random.PRNGKey(1))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": moco_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                 new.opt_state[0]["g"]), {}),
            "params": moco_params_from_jax(jax.tree_util.tree_map(np.asarray, new.params),
                                           jax.tree_util.tree_map(np.asarray, new.ema_params))}


def _pretrain_one_process(state_dict, batch, lr, wd, mom, cw):
    model = tmoco.DiGPretrainModel(**PRE_CFG)
    model.load_state_dict(state_dict)
    state = TrainState(model=model, optimizer=AdamW(model.named_parameters(), lr, wd,
                                                    eps=OPT_EPS))
    state, metrics = make_pretrain_step(model, mom, cw)(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad for n, p in model.named_parameters() if p.requires_grad},
            "params": model.state_dict()}


def _finetune_inputs():
    jm = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    jm = jm.clone(decoder=jm.decoder.clone(dropout=0.0))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((FT_BATCH, 32, 128, 3)),
                        jnp.zeros((FT_BATCH, 25), jnp.int32), jnp.ones((FT_BATCH,), jnp.int32),
                        True)
    params = _perturb(variables["params"], 70)
    batches = []
    for seed in (71, 72):
        rng = np.random.default_rng(seed)
        batches.append({"images": rng.integers(0, 256, (FT_BATCH, 32, 128, 3), dtype=np.uint8),
                        "targets": rng.integers(0, 94, (FT_BATCH, 25)).astype(np.int32),
                        "lengths": np.array([7, 25, 1, 13], np.int32)})
    return jm, params, batches


def _finetune_jax_on_mesh(jm, params, batches, lr, wd, update_freq, opt_name="adamw"):
    mesh = _mesh()
    inner = j_create_optimizer(opt_name, lr, wd, eps=OPT_EPS,
                               clip_grad=CLIP if update_freq > 1 else None,
                               layer_decay=LAYER_DECAY, num_layers=2,
                               frozen=j_frozen_encoder_mask(FROZEN))
    tx = (optax.MultiSteps(inner, every_k_schedule=update_freq) if update_freq > 1
          else optax.chain(_grad_saver(), inner))
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = j_make_finetune_step(jm, smoothing=SMOOTHING, mesh=mesh)
    losses = []
    for batch in batches[:update_freq]:
        state, metrics, _ = step(state, shard_batch(mesh, batch), jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    out = {"losses": losses,
           "params": params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))}
    if update_freq == 1:
        out["grads"] = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              state.opt_state[0]["g"]))
        out["grad_norm"] = float(metrics["grad_norm"])
    return out


def _finetune_one_process(state_dict, batches, lr, wd, update_freq, opt_name="adamw"):
    model = _rec_model()
    model.load_state_dict(state_dict)
    opt = create_optimizer(opt_name, model.named_parameters(), lr, wd, eps=OPT_EPS,
                           clip_grad=CLIP if update_freq > 1 else None, layer_decay=LAYER_DECAY,
                           num_layers=2, frozen=frozen_encoder_mask(FROZEN),
                           update_freq=update_freq)
    state = init_finetune_state(model, opt)
    step = make_finetune_step(model, smoothing=SMOOTHING)
    metrics = []
    for batch in batches[:update_freq]:
        state, m, _ = step(state, batch, torch.Generator().manual_seed(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": model.state_dict(), "count": opt.count,
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def _heads_inputs():
    rng = np.random.default_rng(80)
    bn_inputs = {"rows": rng.normal(size=(PRE_BATCH, 16)) * 3 + 1,
                 "tokens": rng.normal(size=(PRE_BATCH, 3, 16)) * 2 - 1}
    return {"bn_inputs": {k: torch.from_numpy(v.astype(np.float32)) for k, v in bn_inputs.items()},
            "bn_dy": {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                      for k, v in bn_inputs.items()},
            "bn_state": {"weight": torch.from_numpy(rng.normal(1, 0.1, 16).astype(np.float32)),
                         "bias": torch.from_numpy(rng.normal(0, 0.1, 16).astype(np.float32))},
            "q": torch.from_numpy(rng.normal(size=(PRE_BATCH, 16)).astype(np.float32)),
            "k": torch.from_numpy(rng.normal(size=(PRE_BATCH, 16)).astype(np.float32)),
            "t": 0.2, "smoothing": 0.1}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Both ranks' results, the one-process port's and the JAX mesh step's
    on the same weights and global batches.  The ranks run while this
    process computes the rest."""
    root = tmp_path_factory.mktemp("dist_steps")
    sched = {"lr": np.full(4, LR, np.float32), "wd": np.full(4, WD, np.float32)}
    mom, cw = np.full(4, MOM, np.float32), np.full(4, CW, np.float32)
    jpre, pparams, pema, pbatch = _pretrain_inputs()
    pre_sd = moco_params_from_jax(pparams, pema)
    jft, fparams, fbatches = _finetune_inputs()
    ft_sd = params_from_jax(fparams)
    heads = _heads_inputs()
    torch.save({"pretrain": dict(cfg=PRE_CFG, state_dict=pre_sd, batch=pbatch, mom=mom, cw=cw,
                                 eps=OPT_EPS, **sched),
                "finetune": dict(state_dict=ft_sd, batches=fbatches, eps=OPT_EPS,
                                 clip={1: None, 2: CLIP}, layer_decay=LAYER_DECAY, frozen=FROZEN,
                                 smoothing=SMOOTHING, **sched),
                "heads": heads}, root / "inputs.pt")
    procs = _start("steps", root)
    out = {"pre_one": _pretrain_one_process(pre_sd, pbatch, sched["lr"], sched["wd"], mom, cw),
           "pre_jax": _pretrain_jax_on_mesh(jpre, pparams, pema, pbatch, sched["lr"],
                                            sched["wd"], mom, cw),
           "ft_one": _finetune_one_process(ft_sd, fbatches, sched["lr"], sched["wd"], 1),
           "ft_jax": _finetune_jax_on_mesh(jft, fparams, fbatches, sched["lr"], sched["wd"], 1),
           "ft_one_second": _finetune_one_process(ft_sd, fbatches[1:], sched["lr"], sched["wd"],
                                                  1),
           "uf_one": _finetune_one_process(ft_sd, fbatches, sched["lr"], sched["wd"], 2),
           "uf_jax": _finetune_jax_on_mesh(jft, fparams, fbatches, sched["lr"], sched["wd"], 2),
           "lamb_one": _finetune_one_process(ft_sd, fbatches, sched["lr"], sched["wd"], 1,
                                             "lamb"),
           "lamb_jax": _finetune_jax_on_mesh(jft, fparams, fbatches, sched["lr"], sched["wd"], 1,
                                             "lamb"),
           "heads": heads, "pre_sd": pre_sd, "ft_sd": ft_sd}
    out["ranks"] = _finish("steps", root, procs)
    return out


def _check_reduced_grads(ranks_grads, one, jax_grads=None):
    """The reduced gradients are the same on both ranks, equal one process's
    on the global batch within 1e-5 of each leaf's max and JAX's within
    1e-4 (a floor of 1e-6 of the largest gradient for leaves near zero by
    construction, as in the one-process parity tests)."""
    a, b = ranks_grads
    assert sorted(a) == sorted(one)
    floor = 1e-6 * max(float(g.abs().max()) for g in one.values())
    for name, g in one.items():
        assert torch.equal(a[name], b[name]), f"{name}: the ranks' gradients differ"
        _close_to_max(a[name], g, ONE_PROCESS_RTOL, floor, name)
        if jax_grads is not None:
            _close_to_max(a[name], jax_grads[name], 1e-4, floor, name)


def _check_update(ranks_params, one, jax_params, before, lr_scale_atol):
    """Both ranks hold the same parameters after the update; each moved as
    one process moved it (1e-4 of lr: AdamW's m / (sqrt(v) + eps), eps
    1e-3, turns a gradient difference of 1e-5 of a leaf's max into < 1e-4
    of a step; plus the last bit of the tensor's largest entry, onto which
    the step is rounded) and as JAX moved it (1e-3 of lr, the parity
    tests' bound)."""
    a, b = ranks_params
    for name, want in one.items():
        assert torch.equal(a[name], b[name]), f"{name}: the ranks' parameters differ"
        if name not in jax_params:
            continue
        last_bit = float(np.spacing(np.float32(before[name].abs().max())))
        np.testing.assert_allclose((a[name] - before[name]).numpy(),
                                   (want - before[name]).numpy(), rtol=0,
                                   atol=lr_scale_atol * LR / 10 + last_bit, err_msg=name)
        np.testing.assert_allclose((a[name] - before[name]).numpy(),
                                   (jax_params[name] - before[name]).numpy(), rtol=0,
                                   atol=lr_scale_atol * LR, err_msg=name)


def test_pretrain_step_two_ranks_equal_the_global_batch(steps):
    """Loss and metrics: the mean over the ranks is the global batch's (the
    CLI logs that mean); grad_norm is taken after the reduction, so it is
    the same on both ranks."""
    ranks = [r["pretrain"]["metrics"] for r in steps["ranks"]]
    one, jx = steps["pre_one"]["metrics"], steps["pre_jax"]["metrics"]
    assert sorted(ranks[0]) == sorted(one) == sorted(jx)
    assert ranks[0]["grad_norm"] == ranks[1]["grad_norm"]
    for k in ("loss", "loss_contrast", "loss_pixel", "grad_norm"):
        mean = sum(r[k] for r in ranks) / WORLD
        np.testing.assert_allclose(mean, one[k], rtol=ONE_PROCESS_RTOL, err_msg=k)
        np.testing.assert_allclose(mean, jx[k], rtol=1e-4, err_msg=k)  # fp32 through the graph
    for k in ("q1_acc1", "q1_acc5", "q2_acc1", "q2_acc5"):
        assert sum(r[k] for r in ranks) / WORLD == pytest.approx(one[k]) == pytest.approx(jx[k])


def test_pretrain_step_two_ranks_reduce_the_global_gradient(steps):
    _check_reduced_grads([r["pretrain"]["grads"] for r in steps["ranks"]],
                         steps["pre_one"]["grads"], steps["pre_jax"]["grads"])


def test_pretrain_step_two_ranks_update_as_the_global_batch(steps):
    """The student after AdamW and the momentum branch after its EMA."""
    _check_update([r["pretrain"]["params"] for r in steps["ranks"]],
                  steps["pre_one"]["params"], steps["pre_jax"]["params"], steps["pre_sd"], 1e-3)


def test_finetune_step_two_ranks_equal_the_global_batch(steps):
    """The fine-tuning CE divides by the batch (sample_normalize): the mean
    of the ranks' losses is the global one."""
    ranks = [r["finetune"]["metrics"][0] for r in steps["ranks"]]
    one, jx = steps["ft_one"]["metrics"][0], steps["ft_jax"]
    mean = sum(r["loss"] for r in ranks) / WORLD
    np.testing.assert_allclose(mean, one["loss"], rtol=ONE_PROCESS_RTOL)
    np.testing.assert_allclose(mean, jx["losses"][0], rtol=1e-5)
    assert ranks[0]["grad_norm"] == ranks[1]["grad_norm"]
    np.testing.assert_allclose(ranks[0]["grad_norm"], one["grad_norm"], rtol=ONE_PROCESS_RTOL)
    np.testing.assert_allclose(ranks[0]["grad_norm"], jx["grad_norm"], rtol=1e-5)
    _check_reduced_grads([r["finetune"]["grads"] for r in steps["ranks"]], steps["ft_one"]["grads"],
                         jx["grads"])
    frozen = frozen_encoder_mask(FROZEN)
    for r in steps["ranks"]:  # frozen tensors keep their values exactly
        for name, v in r["finetune"]["params"].items():
            if frozen(name):
                assert torch.equal(v, steps["ft_sd"][name]), name
    _check_update([r["finetune"]["params"] for r in steps["ranks"]], steps["ft_one"]["params"],
                  jx["params"], steps["ft_sd"], 1e-3)


def test_update_freq_2_two_ranks_equal_the_global_batch(steps):
    """Two micro-steps, clipping at 0.5: the reducer runs once, on the
    running mean, before the clip, and hands the optimizer the mean of the
    two global micro-batches' gradients (one process's, each from the same
    parameters); one update on both ranks, equal to one process's and to
    optax MultiSteps' over the mesh."""
    for r in steps["ranks"]:
        assert r["finetune_update_freq_2"]["count"] == 1
        assert len(r["finetune_update_freq_2"]["reduced"]) == 1
    first, second = steps["ft_one"]["grads"], steps["ft_one_second"]["grads"]
    _check_reduced_grads([r["finetune_update_freq_2"]["reduced"][0] for r in steps["ranks"]],
                         {n: (first[n] + second[n]) / 2 for n in first})
    one, jx = steps["uf_one"], steps["uf_jax"]
    assert one["count"] == 1
    for i in range(2):
        mean = sum(r["finetune_update_freq_2"]["metrics"][i]["loss"] for r in steps["ranks"]) / WORLD
        np.testing.assert_allclose(mean, one["metrics"][i]["loss"], rtol=ONE_PROCESS_RTOL)
        np.testing.assert_allclose(mean, jx["losses"][i], rtol=1e-5)
    _check_update([r["finetune_update_freq_2"]["params"] for r in steps["ranks"]], one["params"],
                  jx["params"], steps["ft_sd"], 1e-3)


def test_lamb_step_two_ranks_update_as_the_global_batch(steps):
    """A non-AdamW optimizer behind the reducer: one LAMB fine-tuning step
    (its trust ratio reads every parameter's and update's norm) on both
    ranks equals one process's on the global batch and JAX's over the mesh,
    at the bounds of the AdamW step above."""
    ranks = [r["finetune_lamb"] for r in steps["ranks"]]
    one, jx = steps["lamb_one"], steps["lamb_jax"]
    assert all(r["count"] == 1 for r in ranks) and one["count"] == 1
    _check_reduced_grads([r["grads"] for r in ranks], one["grads"], jx["grads"])
    _check_update([r["params"] for r in ranks], one["params"], jx["params"], steps["ft_sd"], 1e-3)


@pytest.mark.parametrize("name", ["rows", "tokens"])
def test_batch_stats_norm_two_ranks_take_global_statistics(steps, name):
    """Forward and backward: the ranks' outputs and input gradients are the
    global batch's rows, their scale and shift gradients sum to the global
    ones; JAX's module on the mesh gives the same forward and gradients
    (fp32 statistics over 8 rows: 1e-5)."""
    h = steps["heads"]
    x, dy = h["bn_inputs"][name], h["bn_dy"][name]
    got = [r[f"bn_{name}"] for r in steps["ranks"]]
    bn = tmoco.BatchStatsNorm(16)
    bn.load_state_dict(h["bn_state"])
    xg = x.clone().requires_grad_(True)
    y = bn(xg)
    (y * dy).sum().backward()
    jbn = jmoco.BatchStatsNorm()
    jparams = {"scale": jnp.asarray(h["bn_state"]["weight"].numpy()),
               "bias": jnp.asarray(h["bn_state"]["bias"].numpy())}
    fwd = lambda p, xx: jbn.apply({"params": p}, xx)  # noqa: E731
    mesh = _mesh()
    xs = shard_batch(mesh, {"x": np.asarray(x)})["x"]
    jy, vjp = jax.vjp(jax.jit(fwd), jparams, xs)
    jdp, jdx = vjp(jnp.asarray(dy.numpy()))
    for key, want, jwant in (("y", y.detach(), jy), ("dx", xg.grad, jdx)):
        cat = torch.cat([g[key] for g in got])
        _close_to_max(cat, want, ONE_PROCESS_RTOL, what=key)
        _close_to_max(cat, np.asarray(jwant), 1e-5, what=key)
    for key, want, jwant in (("dweight", bn.weight.grad, jdp["scale"]),
                             ("dbias", bn.bias.grad, jdp["bias"])):
        total = sum(g[key] for g in got)
        _close_to_max(total, want, ONE_PROCESS_RTOL, what=key)
        _close_to_max(total, np.asarray(jwant), 1e-5, what=key)


def test_infonce_two_ranks_gather_keys_and_offset_labels(steps):
    """The mean of the ranks' losses and accuracies is the global batch's;
    each rank's query gradient, divided by the world size (the global loss
    is the mean of the ranks'), is the global loss's; JAX's loss agrees."""
    h = steps["heads"]
    got = [r["infonce"] for r in steps["ranks"]]
    q = h["q"].clone().requires_grad_(True)
    loss, (acc1, acc5) = info_nce_loss(q, h["k"], h["t"], h["smoothing"], return_acc=True)
    loss.backward()
    np.testing.assert_allclose(sum(g["loss"] for g in got) / WORLD, float(loss.detach()),
                               rtol=ONE_PROCESS_RTOL)
    jloss, (jacc1, jacc5) = jinfonce.info_nce_loss(jnp.asarray(h["q"].numpy()),
                                                   jnp.asarray(h["k"].numpy()), h["t"],
                                                   h["smoothing"], return_acc=True)
    np.testing.assert_allclose(sum(g["loss"] for g in got) / WORLD, float(jloss), rtol=1e-5)
    for key, want in (("acc1", (acc1, jacc1)), ("acc5", (acc5, jacc5))):
        mean = sum(g[key] for g in got) / WORLD
        assert mean == pytest.approx(float(want[0])) == pytest.approx(float(want[1]))
    _close_to_max(torch.cat([g["dq"] for g in got]) / WORLD, q.grad, ONE_PROCESS_RTOL, what="dq")
    # each rank's positives are its own rows of the global keys: rank 1's
    # row 0 is global row 4, whose positive is key 4, not key 0
    assert got[0]["loss"] != got[1]["loss"]


def test_metric_sync_sums_count_and_total_over_the_ranks(steps):
    """Rank r logs 3 + r values and one of 0.5 counted 4 + r times; after
    the sync both ranks hold the sums, and the average is the one process
    would take over every value."""
    values = [(10.0 * r + i, 1) for r in range(WORLD) for i in range(3 + r)]
    values += [(0.5, 4 + r) for r in range(WORLD)]
    count = sum(n for _, n in values)
    total = sum(v * n for v, n in values)
    for r in steps["ranks"]:
        assert r["meter"][0] == count and r["meter"][1] == pytest.approx(total)
        assert r["meter"][2] == pytest.approx(total / count)


def test_preemption_consensus_stops_every_rank_at_one_step(steps):
    """Rank 1 catches SIGTERM at step 4; the decision is polled every 3
    steps, so both ranks stop at step 6, rank 0 on rank 1's flag alone."""
    assert [r["stop_at"] for r in steps["ranks"]] == [6, 6]
    assert [r["local_flag"] for r in steps["ranks"]] == [False, True]


def test_rank_streams_are_distinct_and_rank_0_is_the_single_process(steps):
    d0, d1 = (r["draws"] for r in steps["ranks"])
    for stream in (0, 1):
        assert torch.equal(d0[stream], torch.rand(8, generator=step_generator(7, stream, 5)))
        assert not torch.equal(d0[stream], d1[stream])
    assert not torch.equal(d1[0], d1[1])


# ---------------------------------------------------------------------------
# the CLIs at two ranks
# ---------------------------------------------------------------------------

N_IMAGES = 16  # 2 steps an epoch at 2 ranks x 4


def _write_lmdbs(root):
    import cv2

    from dig_tpu_torch.data.lmdb_store import LmdbWriter

    rng = np.random.default_rng(90)
    paths = {"alone": str(root / "alone"), "labelled": str(root / "labelled")}
    with LmdbWriter(paths["alone"]) as w:
        for i in range(1, N_IMAGES + 1):
            img = rng.integers(0, 256, (32, 100 + 4 * i, 3), dtype=np.uint8)
            w.put(b"image-%09d" % i, cv2.imencode(".png", img)[1].tobytes())
        w.put(b"num-samples", str(N_IMAGES).encode())
    with LmdbWriter(paths["labelled"]) as w:
        for i in range(1, N_IMAGES + 1):
            img = rng.integers(0, 256, (32, 128, 3), dtype=np.uint8)
            w.put(b"image-%09d" % i, cv2.imencode(".png", img)[1].tobytes())
            w.put(b"label-%09d" % i, "abcdefgh"[: 1 + i % 8].encode())
        w.put(b"num-samples", str(N_IMAGES).encode())
    return paths


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    paths = _write_lmdbs(root)
    common = ["--batch_size", "4", "--epochs", "1", "--num_workers", "1", "--dtype", "float32",
              "--seed", "0"]
    pre_out, ft_out = str(root / "pre"), str(root / "ft")
    pretrain_argv = ["--model", "pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                     "--image_alone_path", paths["alone"], "--output_dir", pre_out,
                     "--moco_mlp_dim", "32", "--moco_dim", "16", "--num_windows", "4",
                     "--warmup_steps", "1", "--device_aug", "--worker_type", "process", *common]
    model = ["--model", "vit_micro_patch4_32x128", "--decoder_name", "small_tf_decoder"]
    finetune_argv = [*model, "--data_path", paths["labelled"], "--eval_data_path",
                     paths["labelled"], "--finetune", os.path.join(pre_out, "checkpoint-0"),
                     "--output_dir", ft_out, "--no_use_abi_aug", "--num_view", "1",
                     "--dist_eval", *common]
    eval_args = [*model, "--eval", "--resume", os.path.join(ft_out, "checkpoint-0"),
                 "--eval_data_path", paths["labelled"], "--batch_size", "4", "--num_workers", "1",
                 "--dtype", "float32"]
    torch.save({"pretrain_argv": pretrain_argv, "finetune_argv": finetune_argv,
                "eval_argv": [*eval_args, "--dist_eval", "--output_dir", str(root / "eval2")]},
               root / "inputs.pt")
    ranks = _finish("cli", root, _start("cli", root))
    return dict(root=root, pre_out=pre_out, ft_out=ft_out, ranks=ranks, eval_args=eval_args)


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_cli_two_ranks_write_once_from_rank_0(cli):
    """One line an epoch in log.txt, one screen.txt, the checkpoints of
    each run; the ranks end with the same weights and leave no worker
    process behind."""
    for out, steps in ((cli["pre_out"], 2), (cli["ft_out"], 2)):
        assert [line["epoch"] for line in _log(out)] == [0]
        with open(os.path.join(out, "checkpoint-0", "meta.json")) as f:
            assert json.load(f) == {"step": steps, "extra": {"epoch": 0}}
        with open(os.path.join(out, "screen.txt")) as f:
            screen = f.read()
        assert "devices: 2 (cpu, gloo)" in screen
        assert not [n for n in os.listdir(out) if n.startswith("tmp_")]
    a, b = cli["ranks"]
    for key in ("pretrain", "finetune"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    assert a["pretrain_step"] == b["pretrain_step"] == 2
    assert a["finetune_step"] == b["finetune_step"] == 2
    assert all(r["info"]["backend"] == "gloo" for r in cli["ranks"])
    # the pre-training run's loader ran on process workers: every rank's
    # main stopped them and their forkserver
    assert all(r["left_running"] == [] and r["forkserver"] is None for r in cli["ranks"])


def test_cli_two_ranks_auto_resume_the_same_checkpoint(cli):
    want = os.path.abspath(os.path.join(cli["pre_out"], "checkpoint-0"))
    for r in cli["ranks"]:
        assert r["resumed_from"][0] == want and r["resumed_step"] == 2
        assert all(torch.equal(r["resumed"][k], r["pretrain"][k]) for k in r["pretrain"])


def test_cli_dist_eval_sums_equal_one_process(cli):
    """`--dist_eval` at 2 ranks (8 records each) against one process over
    all 16: the same counts and accuracy; F-measure summed in another order."""
    from dig_tpu_torch.cli import run_finetune
    from dig_tpu_torch.config import FinetuneConfig, parse_config

    one = run_finetune.main(parse_config(FinetuneConfig, cli["eval_args"] + [
        "--output_dir", str(cli["root"] / "eval1")]), device="cpu")
    for r in cli["ranks"]:
        assert len(r["eval"]) == len(one) == 1
        got, want = r["eval"][0], one[0]
        assert got["n"] == want["n"] == N_IMAGES and got["acc"] == pytest.approx(want["acc"])
        assert got["fmeasure"] == pytest.approx(want["fmeasure"], rel=1e-12)
    with open(cli["root"] / "eval2" / "eval_results.json") as f:
        assert json.load(f)["n_images"] == N_IMAGES


# ---------------------------------------------------------------------------
# in this process: what needs no second rank
# ---------------------------------------------------------------------------

def test_one_process_has_no_group_and_the_collectives_are_identities(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
                "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    info = tdist.init_distributed_mode("cpu")
    assert info == {"rank": 0, "world_size": 1, "local_rank": 0, "device": torch.device("cpu"),
                    "backend": None, "created": False}
    x = torch.arange(6.0).reshape(3, 2)
    assert tdist.concat_all_gather(x) is x and tdist.all_reduce_sum(x) is x
    assert tdist.all_reduce_floats([1.5, 2.0]) == [1.5, 2.0]
    g = [torch.ones(2, 2), None]
    reduced = tdist.GradientReducer([torch.zeros(2, 2), torch.zeros(3)]).reduce(g)
    assert torch.equal(reduced[0], g[0]) and torch.equal(reduced[1], torch.zeros(3))


@pytest.mark.parametrize("launcher,want", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1"}, (1, 4, 1)),
    ({"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "3",
      "OMPI_COMM_WORLD_LOCAL_RANK": "0"}, (2, 3, 0)),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1"}, (5, 8, 1)),
    ({"RANK": "0", "WORLD_SIZE": "2", "SLURM_PROCID": "5", "SLURM_NTASKS": "8"}, (0, 2, 0)),
])
def test_rank_discovery_follows_the_launchers_in_order(launcher, want, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
                "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"):
        monkeypatch.delenv(var, raising=False)
    for k, v in launcher.items():
        monkeypatch.setenv(k, v)
    assert tdist._from_launcher() == want


def test_a_launch_without_a_rendezvous_is_refused(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tdist.init_distributed_mode("cpu")
    assert not tdist.is_distributed()
