"""Every recognizer kind's fine-tuning step and eval step in the port against
`dig_tpu.train.finetune`, on the CPU: the metrics, every gradient leaf, the
parameters after one AdamW step and the ids.

The micro encoder (`vit_micro_patch4_32x128`) under each head, decoders cut
to 2 layers; JAX parameters initialized, perturbed with numpy noise and
carried across with `params_from_jax`; batches from numpy seeds.  The JAX
steps always train with dropout on and the JAX decoders hard-code 0.1, so
every rate is 0 on both sides (the JAX decoders cloned at dropout 0):
torch and JAX random streams cannot match.  For the same reason the MIM
step's masks are the test's: `dig_tpu.data.masking.random_mask_batch` (which
the JAX step imports when it is made) and the port's counterpart both
return them.  Everything is fp32.  Tolerances: metrics within 1e-5
relative, every gradient leaf within 1e-4 of its max (a floor of 1e-6 of
the largest gradient for leaves near zero by construction), ids equal.
Two derived ones:

* the distillation projector `feat_proj` (three batch-statistics norms
  over B x L rows, whose backward cancels the part of the gradient along
  the normalized features): in fp32 its gradients lie up to 1.1e-2 of a
  leaf's max from the fp64 value in `dig_tpu` and 9.2e-3 in the port
  (measured on these inputs against the port in fp64), so the packages
  are held to each other at 2e-2 there;
* the AdamW step: after one step u = g / (|g| + eps), whose slope in g is
  at most 1 / eps, so a leaf whose gradients agree to d moves by lr * d /
  eps at most; the step is held at that (at least 1e-3 of lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.optim import create_optimizer as j_create_optimizer
from dig_tpu.train import finetune as jft
from dig_tpu.train.state import TrainState as JTrainState
from dig_tpu_torch import optim as toptim
from dig_tpu_torch.data import masking as tmasking
from dig_tpu_torch.models import decoder as tdec
from dig_tpu_torch.models.rec_model import build_rec_model as t_build_rec_model
from dig_tpu_torch.train import finetune as tft
from dig_tpu_torch.utils.convert import params_from_jax

B = 4
LR, WD, OPT_EPS = 1e-3, 0.05, 1e-3
FEAT_PROJ_RTOL = 2e-2
MICRO = "vit_micro_patch4_32x128"
NUM_MIM, N_PATCHES, MASK_RATIO = 2, 256, 0.7  # round(0.5 * 4) rows masked, int(0.7 * 256) each

# name -> (build_rec_model kwargs, the step)
STEPS = {
    "distill": (dict(decoder_name="small_tf_decoder", use_feat_distill=True), "distill"),
    "distill_1d": (dict(decoder_name="small_tf_decoder", use_feat_distill=True,
                        use_1d_attdec=True), "distill"),
    "ctc": (dict(model_kind="ctc"), "ctc"),
    "mim": (dict(model_kind="mim_rec", decoder_name="small_tf_decoder"), "mim"),
    "mim_proj": (dict(model_kind="mim_rec", decoder_name="small_tf_decoder",
                      use_mim_proj=True), "mim"),
    "attn": (dict(model_kind="attn"), "finetune"),
    "seq_cls": (dict(model_kind="seq_cls"), "finetune"),
    "decoupled": (dict(decoder_name="decoupled_tf_decoder"), "finetune"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_to_max(got, want, rtol, atol=0.0, what=""):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * scale + atol, f"{what}: max abs err {err:.3e} vs max |want| {scale:.3e}"


def _grad_saver():
    """An optax transform that passes grads through and keeps them in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}))


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (b, 32, 128, 3), dtype=np.uint8),
            "targets": rng.integers(0, 94, (b, 25)).astype(np.int32),
            "lengths": np.array([7, 25, 1, 13][:b], np.int32)}


def _mim_mask():
    m = np.zeros((NUM_MIM, 1, N_PATCHES), bool)
    rng = np.random.default_rng(70)
    for row in m:
        row[0, rng.permutation(N_PATCHES)[:int(MASK_RATIO * N_PATCHES)]] = True
    return m


def _jax_model(kw):
    model = j_build_rec_model(MICRO, **kw)
    if kw.get("model_kind") in ("ctc", "attn", "seq_cls"):
        return model
    layers = 2 if kw.get("decoder_name") == "decoupled_tf_decoder" else model.decoder.n_layers
    return model.clone(decoder=model.decoder.clone(dropout=0.0, n_layers=layers))


def _port_model(kw, params):
    model = t_build_rec_model(MICRO, device="cpu", **kw)
    if kw.get("decoder_name") == "decoupled_tf_decoder":
        model.decoder = tdec.DecoupledTFDecoder(97, 25, n_layers=2)
    for m in model.modules():
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.0
    model.load_state_dict(params_from_jax(params))
    return model


def _jax_init(model, kw, batch):
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((B, 32, 128, 3))
    targets, lens = jnp.asarray(batch["targets"]), jnp.asarray(batch["lengths"])
    if kw.get("model_kind") == "ctc":
        return model.init(key, x, True)
    if kw.get("model_kind") == "mim_rec":
        return model.init(key, x, targets, lens, jnp.ones((B, N_PATCHES), bool), B, True)
    return model.init(key, x, targets, lens, True)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p)).astype(np.float32), params)


def _jax_step(model, kind, teacher_params):
    if kind == "distill":
        return jft.make_distill_finetune_step(model, teacher_params, smoothing=0.1)
    if kind == "ctc":
        return jft.make_ctc_step(model, blank_id=97)
    if kind == "mim":
        return jft.make_mim_finetune_step(model, smoothing=0.1, mask_ratio=MASK_RATIO)
    return jft.make_finetune_step(model, smoothing=0.1)


def _port_step(model, kind, teacher):
    if kind == "distill":
        return tft.make_distill_finetune_step(model, teacher, smoothing=0.1)
    if kind == "ctc":
        return tft.make_ctc_step(model, blank_id=97)
    if kind == "mim":
        return tft.make_mim_finetune_step(model, smoothing=0.1, mask_ratio=MASK_RATIO)
    return tft.make_finetune_step(model, smoothing=0.1)


@pytest.fixture(scope="module", params=sorted(STEPS))
def step_pair(request):
    name = request.param
    kw, kind = STEPS[name]
    batch = _batch(41)
    jmodel = _jax_model(kw)
    variables = _jax_init(jmodel, kw, batch)
    params = _perturbed(variables["params"], 40)
    teacher_params = _perturbed(variables["params"], 42) if kind == "distill" else None
    mask = _mim_mask()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("dig_tpu.data.masking.random_mask_batch",
                   lambda key, b, n, num_mask, v=1: jnp.asarray(mask[:b]))
        jstep = _jax_step(jmodel, kind, teacher_params)
        tx = optax.chain(_grad_saver(), j_create_optimizer(
            "adamw", np.full(4, LR, np.float32), np.full(4, WD, np.float32), eps=OPT_EPS))
        state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        new_state, jmetrics, jids = jstep(state, jbatch, jax.random.PRNGKey(1))

        mp.setattr(tmasking, "random_mask_batch",
                   lambda gen, b, n, num_mask, v=1: torch.from_numpy(mask[:b]))
        tmodel = _port_model(kw, params)
        teacher = None
        if kind == "distill":
            tkw = dict(kw, use_feat_distill=False)
            teacher = t_build_rec_model(MICRO, device="cpu", **tkw)
            teacher.load_state_dict({k: v for k, v in params_from_jax(teacher_params).items()
                                     if not k.startswith("feat_proj.")})
            teacher.requires_grad_(False)
        optimizer = toptim.create_optimizer("adamw", tmodel.named_parameters(),
                                            np.full(4, LR, np.float32),
                                            np.full(4, WD, np.float32), eps=OPT_EPS)
        tstate = tft.init_finetune_state(tmodel, optimizer)
        teacher_before = None if teacher is None else {
            k: v.clone() for k, v in teacher.state_dict().items()}
        tstate, tmetrics, tids = _port_step(tmodel, kind, teacher)(
            tstate, batch, torch.Generator().manual_seed(0))
    return dict(name=name, params=params, tmodel=tmodel, teacher=teacher,
                teacher_before=teacher_before, tstate=tstate,
                tmetrics={k: float(v) for k, v in tmetrics.items()}, tids=tids.numpy(),
                jmetrics={k: float(v) for k, v in jmetrics.items()}, jids=np.asarray(jids),
                grads=jax.tree_util.tree_map(np.asarray, new_state.opt_state[0]["g"]),
                new_params=jax.tree_util.tree_map(np.asarray, new_state.params))


def test_step_metrics_and_ids_match_jax(step_pair):
    got, want = step_pair["tmetrics"], step_pair["jmetrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(step_pair["tids"], step_pair["jids"])
    assert step_pair["tstate"].step == 1
    if step_pair["name"].startswith("mim"):
        assert want["loss_pixel"] > 0
    if step_pair["name"].startswith("distill"):
        assert want["loss_distill"] > 0
        for k, v in step_pair["teacher"].state_dict().items():  # the teacher never moves
            assert torch.equal(v, step_pair["teacher_before"][k]), k


def _grad_tolerances(grads):
    """{leaf: the absolute tolerance of its gradient} (module docstring)."""
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    return {name: (FEAT_PROJ_RTOL if name.startswith("feat_proj.") else 1e-4)
            * float(g.abs().max()) + floor for name, g in grads.items()}


def test_step_gradients_match_jax(step_pair):
    want = params_from_jax(step_pair["grads"])
    params = dict(step_pair["tmodel"].named_parameters())
    assert sorted(want) == sorted(params)
    for name, tol in _grad_tolerances(want).items():
        got = params[name].grad
        assert got is not None and torch.isfinite(got).all(), name
        _close_to_max(got.numpy(), want[name].numpy(), 0.0, tol, what=name)


def test_step_update_matches_jax(step_pair):
    state = step_pair["tmodel"].state_dict()
    before = params_from_jax(step_pair["params"])
    tols = _grad_tolerances(params_from_jax(step_pair["grads"]))
    for name, want in params_from_jax(step_pair["new_params"]).items():
        atol = LR * max(1e-3, tols[name] / OPT_EPS)
        np.testing.assert_allclose((state[name] - before[name]).numpy(),
                                   (want - before[name]).numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def decoupled_pair():
    kw = dict(decoder_name="decoupled_tf_decoder")
    batch = _batch(50)
    jmodel = _jax_model(kw)
    params = _perturbed(_jax_init(jmodel, kw, batch)["params"], 51)
    params["decoder"]["classifier"]["bias"][94] += 3.0
    return jmodel, params, _port_model(kw, params), batch


@pytest.mark.parametrize("beam", [0, 3])
def test_eval_step_with_cls_matches_jax(decoupled_pair, beam):
    """The decoupled recognizer's eval: ids, per-row loss and presence logits."""
    jmodel, params, tmodel, batch = decoupled_pair
    jout = jft.make_eval_step(jmodel, beam_width=beam, eos=94, with_cls=True)(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    tout = tft.make_eval_step(tmodel, beam_width=beam, eos=94, with_cls=True)(batch)
    assert len(tout) == 3
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-6)
    _close_to_max(tout[2].numpy(), np.asarray(jout[2]), 1e-5)


def test_ctc_eval_step_matches_jax():
    kw = dict(model_kind="ctc")
    batch = _batch(52)
    jmodel = _jax_model(kw)
    params = _perturbed(_jax_init(jmodel, kw, batch)["params"], 53)
    jids, jloss = jft.make_ctc_eval_step(jmodel)(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    tids, tloss = tft.make_ctc_eval_step(_port_model(kw, params))(batch)
    assert tids.shape == (B, 32)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tloss.numpy(), np.asarray(jloss))


def test_standardize_matches_jax():
    x = np.random.default_rng(54).normal(3.0, 2.0, (5, 7, 64)).astype(np.float32)
    want = np.asarray(jax.nn.standardize(jnp.asarray(x), axis=-1, epsilon=1e-5))
    _close_to_max(tft.standardize(torch.from_numpy(x)).numpy(), want, 1e-5)
