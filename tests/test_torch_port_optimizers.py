"""Every optimizer of the port's factory against `dig_tpu.optim.create_optimizer`,
on the CPU.

The same parameters and gradients (numpy seeds) go through both packages
for 7 updates: a 128 x 160 matrix (Adafactor's factored path), smaller
matrices and 1-D parameters, a ``pos_embed`` (no decay by name), an
embedding and a first block that `frozen_encoder_mask(1)` freezes, layer
decay 0.75 over two blocks, lr and wd schedules and clipping by the global
norm (gradients scaled so that it fires on some steps and not on others).
Tolerances: the parameters after the updates within 1e-6 (relative and
absolute) in fp32, where the two packages round the same formulas apart,
and within 1e-12 in fp64 (`jax.enable_x64`); the optimizer state restored
from a checkpoint repeats the straight run bit for bit; two gloo ranks are
held in tests/test_torch_port_dist.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dig_tpu import optim as joptim
from dig_tpu_torch import optim as toptim
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils import checkpoint as ckpt

SHAPES = {
    "encoder.pos_embed": (1, 4, 8),
    "encoder.patch_embed.proj.weight": (8, 12),
    "encoder.blocks.0.w": (8, 8),
    "encoder.blocks.0.b": (8,),
    "encoder.blocks.1.w": (128, 160),
    "encoder.blocks.1.norm": (160,),
    "head.w": (160, 6),
    "head.b": (6,),
}
STEPS = 7
LR = np.linspace(1e-2, 3e-3, STEPS).astype(np.float32)
WD = np.linspace(0.05, 0.1, STEPS).astype(np.float32)
CLIP = 3.0
BETAS, EPS, MOMENTUM = (0.9, 0.999), 1e-8, 0.9
# every name of dig_tpu/optim.py:266-310 with its aliases, and the prefix
NAMES = sorted(toptim.RULES) + ["lookahead_adamw", "lookahead_lamb", "lookahead_sgd",
                                "lookahead_radam"]
RULE_NAMES = sorted(set(toptim.RULES.values()) - {"adahessian"}) + ["lookahead_lamb"]


def _jpath(name):
    """The port's dotted name -> the JAX tree path (``blocks.0`` -> ``blocks_0``)."""
    parts, out = name.split("."), []
    i = 0
    while i < len(parts):
        if parts[i] == "blocks":
            out.append(f"blocks_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def _tree(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *head, leaf = _jpath(name)
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _leaf(tree, name):
    for k in _jpath(name):
        tree = tree[k]
    return np.asarray(tree)


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=s).astype(dtype) for n, s in SHAPES.items()}
    grads = []
    for i in range(STEPS):
        scale = 10.0 ** rng.uniform(-2.5, -0.5)  # the norm straddles CLIP
        g = {n: (scale * rng.normal(size=s)).astype(dtype) for n, s in SHAPES.items()}
        g["head.b"][:] = 0 if i == 2 else g["head.b"]  # a zero gradient for one step
        grads.append(g)
    return params, grads


def _jax_run(name, params, grads, update_freq=1, hess=None):
    tx = joptim.create_optimizer(
        name, LR, WD, betas=BETAS, eps=EPS, momentum=MOMENTUM, clip_grad=CLIP,
        layer_decay=0.75, num_layers=2, frozen=joptim.frozen_encoder_mask(1))
    if update_freq > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=update_freq)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(params))
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(g)), state, jp)
        jp = optax.apply_updates(jp, updates)
    return {n: _leaf(jp, n) for n in params}


def _port(name, params, update_freq=1):
    tp = {n: torch.from_numpy(p.copy()).requires_grad_() for n, p in params.items()}
    opt = toptim.create_optimizer(
        name, tp.items(), LR, WD, betas=BETAS, eps=EPS, momentum=MOMENTUM, clip_grad=CLIP,
        layer_decay=0.75, num_layers=2, frozen=toptim.frozen_encoder_mask(1),
        update_freq=update_freq)
    return tp, opt


def _port_steps(tp, opt, grads):
    for g in grads:
        for n, t in tp.items():
            t.grad = torch.from_numpy(g[n].copy())
        opt.step()


def _check(tp, want, tol):
    for n, t in tp.items():
        np.testing.assert_allclose(t.detach().numpy(), want[n], rtol=tol, atol=tol, err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_every_name_matches_jax_in_fp32(name):
    params, grads = _inputs()
    if toptim.RULES[name.split("_")[-1]] == "adahessian":
        return _adahessian_without_diag(name, params, grads)
    tp, opt = _port(name, params)
    _port_steps(tp, opt, grads)
    assert opt.count == STEPS
    _check(tp, _jax_run(name, params, grads), 1e-6)
    frozen = [n for n in SHAPES if n.startswith(("encoder.pos", "encoder.patch", "encoder.blocks.0"))]
    for n in frozen:  # lr scale 0: unchanged, whatever the rule's state did
        np.testing.assert_array_equal(tp[n].detach().numpy(), params[n])


def _adahessian_without_diag(name, params, grads):
    """Neither package's factory hands AdaHessian a Hessian diagonal: a step
    raises `ValueError` naming the estimator, in both."""
    tp, opt = _port(name, params)
    for n, t in tp.items():
        t.grad = torch.from_numpy(grads[0][n].copy())
    with pytest.raises(ValueError, match="hutchinson_hessian_diag"):
        opt.step()
    with pytest.raises(ValueError, match="hutchinson_hessian_diag"):
        _jax_run(name, params, grads[:1])


@pytest.mark.parametrize("name", RULE_NAMES)
def test_every_rule_matches_jax_in_fp64(name):
    params, grads = _inputs(1, np.float64)
    tp, opt = _port(name, params)
    _port_steps(tp, opt, grads)
    with jax.enable_x64(True):
        want = _jax_run(name, params, grads)
    assert all(w.dtype == np.float64 for w in want.values())
    _check(tp, want, 1e-12)


@pytest.mark.parametrize("name", ["lamb", "lookahead_sgdp", "adafactor"])
def test_update_freq_2_matches_multisteps(name):
    """optax `MultiSteps(every_k_schedule=2)` around the factory, as
    `dig_tpu/cli/run_finetune.py:330-334` wraps it: 8 micro-steps, 4 updates."""
    params, grads = _inputs(2)
    grads = grads + _inputs(3)[1][:1]
    tp, opt = _port(name, params, update_freq=2)
    _port_steps(tp, opt, grads)
    assert opt.count == 4 and opt.mini_step == 0
    _check(tp, _jax_run(name, params, grads, update_freq=2), 1e-6)


def _scale_invariant_inputs(seed):
    """A matrix whose gradients are orthogonal to its rows (what a
    normalisation layer gives a weight): AdamP's and SGDP's channel view
    projects its update and scales its weight decay."""
    rng = np.random.default_rng(seed)
    params, grads = _inputs(seed)
    w = params["encoder.blocks.1.w"]
    for g in grads:
        x = rng.normal(size=w.shape)
        x -= w * ((x * w).sum(1, keepdims=True) / (w * w).sum(1, keepdims=True))
        g["encoder.blocks.1.w"] = (1e-2 * x).astype(np.float32)
    return params, grads


@pytest.mark.parametrize("name", ["adamp", "sgdp"])
def test_projection_and_wd_ratio_match_jax(name):
    params, grads = _scale_invariant_inputs(4)
    p = torch.from_numpy(params["encoder.blocks.1.w"])
    g = torch.from_numpy(grads[0]["encoder.blocks.1.w"])
    u = g + 0.01 * p  # an update with a radial part, which the projection removes
    out, ratio = toptim._projection(p, g, u, 0.1, 0.01, 1e-8)
    assert ratio is not None and float(ratio) == np.float32(0.01)  # the projection fired
    assert not torch.allclose(out, u, atol=1e-4)
    jout, jratio = joptim._adamp_projection(jnp.asarray(p.numpy()), jnp.asarray(g.numpy()),
                                            jnp.asarray(u.numpy()), 0.1, 0.01, 1e-8)
    assert float(jratio) == float(ratio)
    # fp32 row sums of 160 products in another order: 1e-6 of the largest entry
    assert np.abs(out.numpy() - np.asarray(jout)).max() <= 1e-6 * np.abs(np.asarray(jout)).max()
    tp, opt = _port(name, params)
    _port_steps(tp, opt, grads)
    _check(tp, _jax_run(name, params, grads), 1e-6)


def test_adahessian_on_a_quadratic():
    """loss = 0.5 * sum(a * p^2): H = diag(a), so the Rademacher estimate
    z * (H z) is a itself, in both packages; then 3 AdaHessian updates with
    it against `scale_by_adahessian`, lr 1e-2, no decay or clipping."""
    rng = np.random.default_rng(5)
    a = {n: rng.uniform(0.5, 2.0, size=s) for n, s in (("w", (6, 5)), ("b", (5,)))}
    p0 = {n: rng.normal(size=v.shape) for n, v in a.items()}

    def tloss(p):
        return sum(0.5 * (torch.from_numpy(a[n]) * p[n] ** 2).sum() for n in p)

    tparams = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    diag = toptim.hutchinson_hessian_diag(torch.func.grad(tloss), tparams,
                                          torch.Generator().manual_seed(0))
    again = toptim.hutchinson_hessian_diag(torch.func.grad(tloss), tparams,
                                           torch.Generator().manual_seed(0))
    for n in a:
        np.testing.assert_allclose(diag[n].numpy(), a[n], rtol=1e-15)
        assert torch.equal(diag[n], again[n])
    with jax.enable_x64(True):
        jgrad = jax.grad(lambda p: sum(0.5 * (a[n] * p[n] ** 2).sum() for n in p))
        jdiag = joptim.hutchinson_hessian_diag(jgrad, jax.tree_util.tree_map(jnp.asarray, p0),
                                               jax.random.PRNGKey(0))
        for n in a:
            np.testing.assert_allclose(np.asarray(jdiag[n]), a[n], rtol=1e-15)
        tx = joptim.scale_by_adahessian(*BETAS, EPS)
        jp = jax.tree_util.tree_map(jnp.asarray, p0)
        state = tx.init(jp)
        for _ in range(3):
            g = jgrad(jp)
            u, state = tx.update(g, state, jp, hess_diag=jax.tree_util.tree_map(jnp.asarray, a))
            # the factory's lr is float32 (`dig_tpu/optim.py:356`)
            jp = jax.tree_util.tree_map(lambda q, d: q - float(np.float32(1e-2)) * d, jp, u)
    tp = {n: torch.from_numpy(v.copy()).requires_grad_() for n, v in p0.items()}
    opt = toptim.create_optimizer("adahessian", tp.items(), [1e-2])
    for _ in range(3):
        loss = tloss(tp)
        opt.zero_grad()
        loss.backward()
        opt.step(hess_diag=[torch.from_numpy(a[n]) for n in tp])
    for n in a:
        np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]), rtol=1e-12)


def test_unknown_names_are_refused_as_dig_tpu_refuses_them():
    tp = {"w": torch.zeros(2, 2, requires_grad=True)}
    for name in ("adamx", "lookahead_", "sgd_lion_x", "LAMB_extra"):
        with pytest.raises(ValueError, match="Invalid optimizer"):
            toptim.create_optimizer(name, tp.items(), [1e-3])
        with pytest.raises(ValueError, match="Invalid optimizer"):
            joptim.create_optimizer(name, [1e-3])
    # the name after the last "_" decides, upper case or not, in both packages
    assert isinstance(toptim.create_optimizer("Fused_LAMB", tp.items(), [1e-3]),
                      toptim.OptaxOptimizer)
    assert isinstance(toptim.create_optimizer("FusedAdamW", tp.items(), [1e-3]), toptim.AdamW)


class _Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for n, p in params.items():
            self.register_parameter(n.replace(".", "_"), torch.nn.Parameter(torch.from_numpy(
                p.copy())))


@pytest.mark.parametrize("name", RULE_NAMES + ["adamw", "lookahead_adamw"])
@pytest.mark.parametrize("update_freq", [1, 2])
def test_checkpoint_round_trip_repeats_the_straight_run(name, update_freq, tmp_path):
    """3 micro-steps, a checkpoint (`save_checkpoint` -> `restore_checkpoint`
    -> `load_into_state` into a fresh model and optimizer), 4 more: equal
    bit for bit to 7 straight micro-steps, parameters and optimizer state
    (under `update_freq` 2 the save falls between the two micro-steps of an
    update)."""
    params, grads = _inputs(6)

    def fresh():
        model = _Params(params)
        opt = toptim.create_optimizer(
            name, model.named_parameters(), LR, WD, betas=BETAS, eps=EPS, clip_grad=CLIP,
            layer_decay=0.75, num_layers=2, update_freq=update_freq)
        return TrainState(model=model, optimizer=opt)

    def run(state, gs):
        for g in gs:
            for n, t in zip(SHAPES, state.model.parameters()):  # registered in this order
                t.grad = torch.from_numpy(g[n].copy())
            state.optimizer.step()
            state.step += 1

    straight = fresh()
    run(straight, grads)
    first = fresh()
    run(first, grads[:3])
    path = ckpt.save_checkpoint(str(tmp_path), 0, first)
    resumed = ckpt.load_into_state(fresh(), ckpt.restore_checkpoint(path))
    run(resumed, grads[3:])
    for (n, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n
    _state_equal(straight.optimizer.state_dict(), resumed.optimizer.state_dict())
    assert resumed.optimizer.count == straight.optimizer.count


def _state_equal(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _state_equal(x, y)
    else:
        assert a == b


def test_a_checkpoint_of_another_optimizer_is_refused(tmp_path):
    params, grads = _inputs(7)
    model = _Params(params)
    lamb = toptim.create_optimizer("lamb", model.named_parameters(), LR)
    path = ckpt.save_checkpoint(str(tmp_path), 0, TrainState(model=model, optimizer=lamb))
    lion = toptim.create_optimizer("lion", model.named_parameters(), LR)
    with pytest.raises(ValueError, match="'lamb'.*'lion'"):
        ckpt.load_into_state(TrainState(model=model, optimizer=lion),
                             ckpt.restore_checkpoint(path))
