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
eps 1e-3, as tests/test_torch_port_pretrain.py runs it.

Both packages' steps are fp32, and a ReLU in the student's heads takes the
gradient through one side of its kink only: an input a few ulps from zero
may fall on either side in the two packages, and then the step's gradients
part by far more than the bounds (one such element of the pix projector
put two leaves 70x over them).  So every fixture that compares such a step
first asserts `assert_relu_margin` on its weights and batch, and each
fixture's perturbation seed is one whose draw meets it."""

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
from dig_tpu_torch.ops.images import to_model_images
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
# perturbation seeds whose draws meet `assert_relu_margin`: the plain and
# remat model at batch 2, and the conv extractor's at batch 6
SEEDS = {"regular": 11, "conv": 807}
RELU_MARGIN_ULPS, ROUNDING_SHARE = 4, 0.5
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


def student_relu_inputs(model, forward):
    """The input of every ReLU module of `model` but the momentum branch's
    (which takes no gradient), by name, from `forward(model)`."""
    got, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.ReLU) and not name.startswith(("momentum_",
                                                                   "pix_projector_m")):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: got.__setitem__(name, args[0].detach())))
    try:
        with torch.no_grad():
            forward(model)
    finally:
        for h in hooks:
            h.remove()
    return got


def assert_relu_margin(model, model64, forward):
    """The precondition of an fp32 gradient comparison across the packages:
    every ReLU input of the student's heads in the port's fp32 forward
    (`forward(model)`) sits at least a margin from zero, the larger of
    RELU_MARGIN_ULPS fp32 ulps of that tensor's largest |x| and
    ROUNDING_SHARE of the port's own rounding of it: its largest difference
    from `forward(model64)`, the same weights built and run in fp64.

    Measured on the draws that failed (perturbation seed 21): one element
    of the pix projector's second ReLU input lay on the other side of zero
    in `dig_tpu`, 2.4 ulps from the port's value at batch 2 and 1.8 at the
    conv extractor's batch 6.  The margin is about twice that.  The port's
    own rounding is 7-8 ulps on the pix projector's inputs and grows to
    hundreds on the heads over the window features; the two packages' fp32
    inputs differed by up to 1.9 times it.  All of it cannot be asked at
    batch 6, where each of the pix projector's two ReLUs takes 786,432
    inputs: none of 1,600 draws kept them all that far from zero, and 21
    kept them half as far (tests/_torch_port_relu_kink.py measures all of
    this)."""
    x32 = student_relu_inputs(model, forward)
    x64 = student_relu_inputs(model64, forward)
    assert x32, "no ReLU in the student's heads"
    for name, x in x32.items():
        ulp = float(np.spacing(np.float32(x.abs().max())))
        rounding = float((x.double() - x64[name]).abs().max())
        margin = max(RELU_MARGIN_ULPS * ulp, ROUNDING_SHARE * rounding)
        closest = float(x.abs().min())
        assert closest >= margin, (
            f"{name}: a ReLU input sits {closest:.3e} from zero, within the margin "
            f"{margin:.3e}; the packages may put it on either side: take another draw")


def pretrain_forward(batch):
    """`forward(model)` for `assert_relu_margin`: the student's forward of
    a pre-training step on `batch`, in the model's dtype, its mask as the
    step flattens it."""
    def forward(model):
        dtype = next(model.parameters()).dtype
        images = torch.cat([to_model_images(torch.as_tensor(batch[k]))
                            for k in ("images", "aug_images")]).to(dtype)
        mask = torch.as_tensor(batch["mask"]).clone()
        mask[:, 1] = False  # the aug view unmasked, as the step has it
        model.forward_student(images, mask.transpose(0, 1).reshape(-1, mask.shape[-1]))
    return forward


def check_relu_margin(cfg, params, ema, batch, **model_kw):
    """`assert_relu_margin` on the port's model with these JAX weights."""
    state = moco_params_from_jax(params, ema)
    model = tmoco.DiGPretrainModel(**cfg, **model_kw)
    model.load_state_dict(state)
    model64 = tmoco.DiGPretrainModel(**cfg, **model_kw, dtype=torch.float64).double()
    model64.load_state_dict(state)
    assert_relu_margin(model, model64, pretrain_forward(batch))


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
    and results, once the draw is shown to meet `assert_relu_margin`."""
    model = jmoco.DiGPretrainModel(**CFG, **model_kw)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2 * b, 32, 128, 3)),
                           jnp.zeros((2 * b, 256), bool), True)
    params = perturb(variables["params"], SEEDS[model.patchnet_name])
    ema = perturb({k: params[k] for k in model.ema_submodules()}, 22)
    data = batch(b)
    check_relu_margin(CFG, params, ema, data, **model_kw)
    lr, wd = np.full(4, LR, np.float32), np.full(4, WD, np.float32)
    tx = optax.chain(_grad_saver(), j_make_optimizer(lr, wd, eps=OPT_EPS))
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx,
                               ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    step = j_make_pretrain_step(model, np.full(4, MOM, np.float32), np.full(4, CW, np.float32))
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
