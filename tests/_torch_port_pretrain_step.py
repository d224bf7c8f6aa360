"""One pre-training step in both packages from the same weights, for the
parity tests of the pre-training model's options
(tests/test_torch_port_remat.py, tests/test_torch_port_conv_patchnet.py).

A width-128 model (2 heads x 64, depth 2, mlp_dim 32, dim 16, 4 windows)
at batch 2 (or more: InfoNCE's top-5 accuracy needs 5 keys, which the conv
extractor's one window gives at batch 5): the encoder has 2 * 2 * 256 =
1,024 LayerNorm rows of 128 and L = 256, so the port's CPU path goes through both kernel-pair autograd
Functions.  JAX
parameters are initialized, perturbed with numpy noise and carried across
with `moco_params_from_jax`; the batch comes from a numpy seed; AdamW with
eps 1e-3, as tests/test_torch_port_pretrain.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dig_tpu.models import moco as jmoco
from dig_tpu.optim import make_optimizer as j_make_optimizer
from dig_tpu.train.pretrain import make_pretrain_step as j_make_pretrain_step
from dig_tpu.train.state import TrainState as JTrainState
from dig_tpu_torch.models import moco as tmoco
from dig_tpu_torch.ops import attention as tattn
from dig_tpu_torch.ops import layernorm as tln
from dig_tpu_torch.optim import AdamW
from dig_tpu_torch.train.pretrain import make_pretrain_step
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils.convert import moco_params_from_jax

CFG = dict(img_size=(32, 128), patch_size=4, encoder_embed_dim=128, encoder_depth=2,
           encoder_num_heads=2, decoder_num_classes=48, decoder_embed_dim=64, mlp_ratio=4.0,
           qkv_bias=True, mlp_dim=32, dim=16, temperature=0.2, num_windows=4)
B = 2
LR, WD, MOM, CW = 1e-3, 0.05, 0.5, 0.1
OPT_EPS = 1e-3
COUNTED = ((tattn, "attention_lse_fwd"), (tattn, "attention_lse_bwd"),
           (tln, "layer_norm_fwd"), (tln, "layer_norm_bwd"))


def perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=np.shape(p)).astype(np.float32), tree)


def close_to_max(got, want, rtol, atol=0.0, what=""):
    """max |got - want| within rtol of max |want| (plus atol)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale + atol, f"{what}: max abs err {err:.3e} vs max |want| {scale:.3e}"


def _grad_saver():
    """An optax transform that passes grads through and keeps them in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}))


def batch(b, seed=20):
    rng = np.random.default_rng(seed)
    out = {"images": rng.integers(0, 256, (b, 32, 128, 3), dtype=np.uint8),
           "aug_images": rng.integers(0, 256, (b, 32, 128, 3), dtype=np.uint8),
           "mask": np.zeros((b, 2, 256), bool)}
    for r in range(b):
        for v in range(2):
            out["mask"][r, v, rng.permutation(256)[:179]] = True
    return out


def jax_step(b=B, **model_kw):
    """The JAX package's step on perturbed weights at batch `b`: its inputs
    and results."""
    model = jmoco.DiGPretrainModel(**CFG, **model_kw)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2 * b, 32, 128, 3)),
                           jnp.zeros((2 * b, 256), bool), True)
    params = perturb(variables["params"], 21)
    ema = perturb({k: params[k] for k in model.ema_submodules()}, 22)
    lr, wd = np.full(4, LR, np.float32), np.full(4, WD, np.float32)
    tx = optax.chain(_grad_saver(), j_make_optimizer(lr, wd, eps=OPT_EPS))
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx,
                               ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    step = j_make_pretrain_step(model, np.full(4, MOM, np.float32), np.full(4, CW, np.float32))
    data = batch(b)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in data.items()},
                        jax.random.PRNGKey(1))
    return dict(params=params, ema=ema, batch=data, lr=lr, wd=wd,
                grads=moco_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                  new.opt_state[0]["g"]), {}),
                new_params=moco_params_from_jax(jax.tree_util.tree_map(np.asarray, new.params),
                                                jax.tree_util.tree_map(np.asarray,
                                                                       new.ema_params)),
                metrics={k: float(v) for k, v in metrics.items()})


def port_step(jax_run, generator=None, **model_kw):
    """The port's step on the JAX run's weights and batch, counting the
    calls of the four kernel wrappers of the path (on the CPU each takes
    its plain version)."""
    model = tmoco.DiGPretrainModel(**CFG, **model_kw)
    model.load_state_dict(moco_params_from_jax(jax_run["params"], jax_run["ema"]))
    state = TrainState(model=model, optimizer=AdamW(model.named_parameters(), jax_run["lr"],
                                                    jax_run["wd"], eps=OPT_EPS))
    step = make_pretrain_step(model, np.full(4, MOM, np.float32), np.full(4, CW, np.float32))
    calls = dict.fromkeys((name for _, name in COUNTED), 0)

    def counting(name, real):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapper

    saved = [getattr(mod, name) for mod, name in COUNTED]
    try:
        for mod, name in COUNTED:
            setattr(mod, name, counting(name, getattr(mod, name)))
        state, metrics = step(state, jax_run["batch"], generator)
    finally:
        for (mod, name), real in zip(COUNTED, saved):
            setattr(mod, name, real)
    return dict(model=model, state=state, calls=calls,
                metrics={k: float(v) for k, v in metrics.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.requires_grad},
                params={k: v.clone() for k, v in model.state_dict().items()})


def check_against_jax(jax_run, port_run):
    """Loss terms within 1e-4 relative; every gradient leaf within 1e-4 of
    its max |g| (a floor of 1e-6 of the largest gradient for leaves that are
    zero by construction) and the momentum branch after the EMA within
    1e-6: the bounds of tests/test_torch_port_pretrain.py.  The parameters
    after the first AdamW step move by lr * g / (|g| + eps), whose slope in
    g is at most 1 / eps: each leaf's move within lr x (its gradient bound)
    / eps."""
    got, want = port_run["metrics"], jax_run["metrics"]
    for k in ("loss", "loss_contrast", "loss_pixel", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert sorted(port_run["grads"]) == sorted(jax_run["grads"])
    floor = 1e-6 * max(float(g.abs().max()) for g in jax_run["grads"].values())
    for name, g in jax_run["grads"].items():
        close_to_max(port_run["grads"][name], g, 1e-4, floor, name)
    before = moco_params_from_jax(jax_run["params"], jax_run["ema"])
    for name, want_p in jax_run["new_params"].items():
        got_p = port_run["params"][name].numpy()
        if name.startswith(("momentum_", "pix_projector_m")):
            np.testing.assert_allclose(got_p, want_p.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            g_bound = 1e-4 * float(jax_run["grads"][name].abs().max()) + floor
            np.testing.assert_allclose(got_p - before[name].numpy(),
                                       want_p.numpy() - before[name].numpy(), rtol=0,
                                       atol=LR * g_bound / OPT_EPS, err_msg=name)
