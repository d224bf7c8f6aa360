"""Parameter sharding of the port on the CPU, over gloo: the pre-training
and fine-tuning steps on the meshes 1x2x1 (FSDP), 1x1x2 (tensor), 1x2x2 and
2x1x2 against the port's one process on the global batch and against the
JAX package's single-device step, which `dig_tpu`'s own mesh-invariance
test (tests/test_variant_and_mesh_invariance.py) ties its sharded step to.

Each mesh's ranks are launched once (`tests/_torch_port_sharded_worker.py`
through `tests/_torch_port_ranks.py`), with every scenario in that launch,
all meshes and the one-process reference at the same time; this process
computes the JAX steps meanwhile.  Weights: JAX's init, perturbed, carried
to the port in float32 by the converters and promoted to float64 on both
sides, so both start from the same numbers.  Everything runs in float64
(the losses' fp32 islands aside, as in both packages), every >= 2-D leaf
is sharded (``min_size`` 1), dropout is off but where stated, and the
masks have exact counts (the data-parallel loss is the mean of the ranks'
only then, as the loaders give them).

Bounds: `dig_tpu`'s float64 ones against JAX (loss 1e-6 relative, params
1e-7 absolute); against the port's one process the same loss bound (the
fine-tuning loss is summed in fp32) and params within 1e-12 (float64 sums
in another order).
"""

import os
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX optimizers)
import pytest
import torch

import _torch_port_ranks as ranks_mod
import _torch_port_sharded_worker as W
from _torch_port_threads import one_thread
from dig_tpu.models import moco as jmoco
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.optim import create_optimizer as j_create_optimizer
from dig_tpu.train.finetune import make_finetune_step as j_make_finetune_step
from dig_tpu.train.pretrain import make_pretrain_step as j_make_pretrain_step
from dig_tpu.train.state import TrainState as JTrainState
from dig_tpu_torch.parallel.mesh import clear_mesh, create_mesh
from dig_tpu_torch.utils import convert
from dig_tpu_torch.utils.checkpoint import save_checkpoint


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


MESHES = ["1x2x1", "1x1x2", "1x2x2", "2x1x2"]
TENSOR_MESHES = [m for m in MESHES if m.endswith("x2")]
LOSS_RTOL, JAX_PARAM_ATOL, PORT_PARAM_ATOL = 1e-6, 1e-7, 1e-12


def _world(spec):
    return int(np.prod([int(a) for a in spec.split("x")]))


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=np.shape(p)).astype(np.float32), tree)


def _f64_convert():
    """The converters, writing float64 (the JAX results are float64)."""
    return unittest.mock.patch.object(
        convert, "_t", lambda v: torch.from_numpy(np.array(v, dtype=np.float64)))


def _sched():
    return {"lr": np.linspace(1e-3, 5e-4, W.STEPS + 1).astype(np.float32),
            "wd": np.full(W.STEPS + 1, 0.05, np.float32)}


def _pre_batches(rng):
    out = []
    for _ in range(W.STEPS):
        b = {"images": rng.integers(0, 256, (W.PRE_BATCH, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (W.PRE_BATCH, 32, 128, 3), dtype=np.uint8),
             "mask": np.zeros((W.PRE_BATCH, 2, 256), bool)}
        for r in range(W.PRE_BATCH):
            for v in range(2):
                b["mask"][r, v, rng.permutation(256)[:179]] = True
        out.append(b)
    return out


def _pretrain_init(cfg, seed):
    jm = jmoco.DiGPretrainModel(**cfg)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((4, 32, 128, 3)), jnp.zeros((4, 256), bool),
                True)
    params = _perturb(v["params"], seed + 1)
    ema = {k: params[k] for k in jm.ema_submodules()}
    sd = {k: t.double() for k, t in convert.moco_params_from_jax(params, ema).items()}
    return params, ema, sd


def _jax_pretrain(params, ema, batches, sched, mom, cw):
    """`dig_tpu`'s pre-training step on one device, in float64."""
    with jax.enable_x64(True):
        jm = jmoco.DiGPretrainModel(**W.PRE_CFG, dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), t)  # noqa
        tx = j_create_optimizer("adamw", sched["lr"], sched["wd"], eps=W.OPT_EPS,
                                clip_grad=W.CLIP)
        state = JTrainState.create(f64(params), tx, ema_params=f64(ema))
        step = j_make_pretrain_step(jm, mom, cw)
        losses = []
        for i, b in enumerate(batches):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        with _f64_convert():
            return losses, convert.moco_params_from_jax(host(state.params), host(state.ema_params))


def _jax_finetune(params, batches, sched):
    with jax.enable_x64(True):
        jm = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", dtype=jnp.float64)
        jm = jm.clone(decoder=jm.decoder.clone(dropout=0.0))
        tx = j_create_optimizer("adamw", sched["lr"], sched["wd"], eps=W.OPT_EPS,
                                clip_grad=W.CLIP)
        state = JTrainState.create(jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), params), tx)
        step = j_make_finetune_step(jm, smoothing=W.SMOOTHING)
        losses = []
        for i, b in enumerate(batches):
            state, m, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                               jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
        with _f64_convert():
            return losses, convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(90)
    sched = _sched()
    mom, cw = np.full(W.STEPS + 1, 0.5, np.float32), np.full(W.STEPS + 1, 0.1, np.float32)
    pparams, pema, pre_sd = _pretrain_init(W.PRE_CFG, 0)
    _, _, heads3_sd = _pretrain_init(W.HEADS3_CFG, 3)
    jft = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    fparams = _perturb(jft.init(jax.random.PRNGKey(5), jnp.zeros((2, 32, 128, 3)),
                                jnp.zeros((2, 25), jnp.int32), jnp.ones((2,), jnp.int32),
                                True)["params"], 6)
    ft_sd = {k: t.double() for k, t in convert.params_from_jax(fparams).items()}
    fbatches = [{"images": rng.integers(0, 256, (W.FT_BATCH, 32, 128, 3), dtype=np.uint8),
                 "targets": rng.integers(0, 94, (W.FT_BATCH, 25)).astype(np.int32),
                 "lengths": np.array([7, 25, 1, 13], np.int32)} for _ in range(W.STEPS)]
    inp = {"pretrain": dict(state_dict=pre_sd, batches=_pre_batches(rng), sched=sched, mom=mom,
                            cw=cw),
           "finetune": dict(state_dict=ft_sd, batches=fbatches, sched=sched),
           "heads3_state_dict": heads3_sd}
    # the one-process checkpoint every mesh resumes: after one step
    mesh = create_mesh()
    try:
        _, state = W.run_pretrain(inp, mesh, inp["pretrain"]["batches"][:1])
        save_checkpoint(str(root / "ckpt"), 0, state)
    finally:
        clear_mesh()
    torch.save(inp, root / "inputs.pt")
    launched = {}
    for spec in ["1x1x1"] + MESHES:
        d = root / spec
        d.mkdir()
        for name in ("inputs.pt",):
            os.link(root / name, d / name)
        os.symlink(root / "ckpt", d / "ckpt")
        launched[spec] = (d, ranks_mod.start(spec, d, _world(spec)))
    out = {"jax_pretrain": _jax_pretrain(pparams, pema, inp["pretrain"]["batches"], sched, mom,
                                         cw),
           "jax_finetune": _jax_finetune(fparams, fbatches, sched)}
    for spec, (d, procs) in launched.items():
        out[spec] = ranks_mod.finish(spec, d, procs)
    out["root"] = root
    return out


def _dp_mean(ranks, scenario, key="loss"):
    """Each step's metric averaged over the data-parallel ranks (tensor
    peers hold the same value: one of each)."""
    seen = {}
    for r in ranks:
        d, f, _ = r["coords"]
        seen.setdefault((d, f), r[scenario]["metrics"])
    per_rank = list(seen.values())
    return [np.mean([m[i][key] for m in per_rank]) for i in range(len(per_rank[0]))]


def _close(got, want, atol, what):
    assert sorted(got) == sorted(want), what
    worst = max(float((got[k].double() - want[k].double()).abs().max()) for k in want)
    assert worst <= atol, f"{what}: max abs err {worst:.3e}"


def _check_losses(got, want, what):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_sharded_steps_equal_one_process(runs, mesh, kind):
    """Three steps: the losses, the global grad norm (equal on every rank)
    and the whole parameters after, against one process on the global batch."""
    ranks, one = runs[mesh], runs["1x1x1"][0]
    _check_losses(_dp_mean(ranks, kind), _dp_mean([one], kind), f"{mesh} {kind}")
    norms = [r[kind]["metrics"][-1]["grad_norm"] for r in ranks]
    assert len(set(norms)) == 1, norms
    np.testing.assert_allclose(norms[0], one[kind]["metrics"][-1]["grad_norm"], rtol=1e-12)
    _close(ranks[0][kind]["params"], one[kind]["params"], PORT_PARAM_ATOL, f"{mesh} {kind}")


@pytest.mark.parametrize("mesh", ["1x1x1"] + MESHES)
@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_sharded_steps_equal_dig_tpu(runs, mesh, kind):
    """The same steps against `dig_tpu`'s single-device step, at its
    float64 mesh-invariance bounds."""
    losses, params = runs[f"jax_{kind}"]
    ranks = runs[mesh]
    _check_losses(_dp_mean(ranks, kind), losses, f"{mesh} {kind} vs dig_tpu")
    got = ranks[0][kind]["params"]
    _close({k: got[k] for k in params}, params, JAX_PARAM_ATOL, f"{mesh} {kind} vs dig_tpu")


@pytest.mark.parametrize("mesh", TENSOR_MESHES)
def test_heads_the_tensor_group_does_not_divide(runs, mesh):
    """3 heads over 2 tensor ranks: the attention gathers its weights and
    runs whole on every peer; one step equals one process's."""
    ranks, one = runs[mesh], runs["1x1x1"][0]
    _check_losses(_dp_mean(ranks, "heads3"), _dp_mean([one], "heads3"), mesh)
    _close(ranks[0]["heads3"]["params"], one["heads3"]["params"], PORT_PARAM_ATOL, mesh)


@pytest.mark.parametrize("option", ["lamb", "update_freq_2", "remat"])
def test_options_under_fsdp(runs, option):
    """`--opt lamb` (the trust ratio's norms over the whole tensors),
    `--update_freq 2` (one reduction of the running mean) and `--remat`
    (the gather again inside the recompute), one update each on 1x2x1."""
    ranks, one = runs["1x2x1"], runs["1x1x1"][0]
    _check_losses(_dp_mean(ranks, option), _dp_mean([one], option), option)
    _close(ranks[0][option]["params"], one[option]["params"], PORT_PARAM_ATOL, option)
    if option == "update_freq_2":
        assert ranks[0][option]["count"] == one[option]["count"] == 1


@pytest.mark.parametrize("mesh", ["1x2x1", "1x1x2"])
@pytest.mark.parametrize("opt", W.OPTIMIZERS)
def test_optimizers_count_each_element_once(runs, mesh, opt):
    """AdamP's projection (row norms and cosines over the whole rows, the
    rows' maximum over the group where the piece splits them), NovoGrad's
    norms and Adafactor's factored means (over the whole axes; its factors
    chosen by the whole shape): one update equals one process's."""
    ranks, one = runs[mesh], runs["1x1x1"][0]
    _check_losses(_dp_mean(ranks, opt), _dp_mean([one], opt), f"{mesh} {opt}")
    _close(ranks[0][opt]["params"], one[opt]["params"], PORT_PARAM_ATOL, f"{mesh} {opt}")


@pytest.mark.parametrize("mesh", TENSOR_MESHES)
@pytest.mark.parametrize("kind", ["dropout_finetune", "dropout_pretrain"])
def test_tensor_peers_hold_replicated_leaves_bit_equal(runs, mesh, kind):
    """Dropout, attention dropout and drop-path on: tensor peers draw the
    same masks (the step's stream is keyed by the data-parallel index, the
    attention mask drawn for all heads and sliced), so their replicated
    parameters stay bit-equal after the step."""
    ranks = runs[mesh]
    groups = {}
    for r in ranks:
        groups.setdefault(r["coords"][:2], []).append(r[kind]["replicated"])
    for peers in groups.values():
        assert len(peers) == 2
        a, b = peers
        assert sorted(a) == sorted(b) and len(a) > 10
        assert all(torch.equal(a[n], b[n]) for n in a), [n for n in a if not torch.equal(a[n], b[n])]


@pytest.mark.parametrize("mesh", MESHES)
def test_checkpoint_is_the_same_whatever_the_mesh(runs, mesh):
    """A one-process checkpoint restored into the mesh and saved again is
    the one-process run's file byte for byte (rank 0 writes the gathered
    whole tensors); the next step from it equals one process's."""
    ranks, one = runs[mesh], runs["1x1x1"][0]
    with open(os.path.join(one["resume"]["path"], "checkpoint.pth"), "rb") as f:
        want = f.read()
    with open(os.path.join(ranks[0]["resume"]["path"], "checkpoint.pth"), "rb") as f:
        assert f.read() == want
    got = np.mean([r["resume"]["metrics"]["loss"] for r in ranks])
    np.testing.assert_allclose(got, one["resume"]["metrics"]["loss"], rtol=LOSS_RTOL)
    _close(ranks[0]["resume"]["params"], one["resume"]["params"], PORT_PARAM_ATOL, mesh)


def test_reducer_divides_by_the_data_parallel_ranks(runs):
    """`GradientReducer` divides by the data-parallel ranks of the mesh, not
    the world: 1 on 1x1x2, whose two ranks are tensor peers; under FSDP the
    pieces' reducer (over ``data``) divides by data x fsdp as well."""
    assert runs["1x1x2"][0]["divisors"] == [1]
    assert runs["1x2x1"][0]["divisors"] == [2, 2]
    assert runs["1x2x2"][0]["divisors"] == [2, 2]
    assert runs["2x1x2"][0]["divisors"] == [2]
