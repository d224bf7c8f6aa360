"""The port's pre-training modules and one pre-training step against the
JAX package, on the CPU.

JAX parameters are initialized, perturbed with numpy noise (so norm
scales, BN affines and biases are non-trivial) and carried across with
`moco_params_from_jax`; inputs come from numpy seeds.  The step runs a
width-128 model (2 heads x 64, depth 2, mlp_dim 96, dim 16, 4 windows) at
batch 2: its encoder has 2 * 2 * 256 = 1024 LayerNorm rows and L = 256,
so the port's CPU path goes through both kernel-pair autograd Functions
(with their plain backward versions), while the JAX CPU path takes plain
autodiff of `_ref_attention` and `_ln_ref`.  The step runs twice: as is,
and under the opt-in switches `DIG_TPU_ATTN_STORE_LSE=0` and
`DIG_TPU_FUSED_BIAS_GRAD=1`, held against the same JAX step.  Everything is fp32; each
tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_pretrain_step import assert_relu_margin, check_relu_margin
from _torch_port_threads import one_thread
from dig_tpu.models import moco as jmoco
from dig_tpu.models.layers import CrossBlock as JCrossBlock
from dig_tpu.models.registry import create_model as j_create_model
from dig_tpu.optim import make_optimizer as j_make_optimizer
from dig_tpu.train.pretrain import make_pretrain_step as j_make_pretrain_step
from dig_tpu.train.state import TrainState as JTrainState
from dig_tpu.utils.checkpoint import convert_torch_moco
from dig_tpu_torch.models import moco as tmoco
from dig_tpu_torch.models.layers import CrossBlock as TCrossBlock
from dig_tpu_torch.models.registry import create_model as t_create_model
from dig_tpu_torch.ops import attention as tattn
from dig_tpu_torch.ops import fused_dense as tfd
from dig_tpu_torch.ops import layernorm as tln
from dig_tpu_torch.optim import AdamW
from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils.convert import (
    _cross_patchnet,
    _encoder,
    _mlp_head,
    _pix_decoder,
    moco_params_from_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=np.shape(p)).astype(np.float32), tree)


def _np(t):
    return t.detach().numpy()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close_to_max(got, want, rtol, atol=0.0):
    """max |got - want| within rtol of max |want| (plus atol)."""
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= rtol * scale + atol, f"max abs err {err:.3e} vs max |want| {scale:.3e}"


def test_batch_stats_norm_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 6, 16)).astype(np.float32) * 3 + 1
    jbn = jmoco.BatchStatsNorm()
    params = _perturb(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = np.asarray(jbn.apply({"params": params}, jnp.asarray(x)))
    tbn = tmoco.BatchStatsNorm(16)
    tbn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                         "bias": torch.from_numpy(params["bias"])})
    # fp32 statistics over 12 rows: a few ulp
    np.testing.assert_allclose(_np(tbn(torch.from_numpy(x))), want, rtol=1e-5, atol=1e-5)
    plain = jmoco.BatchStatsNorm(affine=False)
    want = np.asarray(plain.apply({}, jnp.asarray(x)))
    assert list(tmoco.BatchStatsNorm(16, affine=False).parameters()) == []
    np.testing.assert_allclose(_np(tmoco.BatchStatsNorm(16, affine=False)(torch.from_numpy(x))),
                               want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gw,windows", [(32, 4), (32, 5), (7, 3)])
def test_adaptive_window_pool_matches_jax(gw, windows):
    x = np.random.default_rng(1).normal(size=(2, 8, gw, 16)).astype(np.float32)
    want = np.asarray(jmoco.adaptive_window_pool(jnp.asarray(x), windows))
    got = _np(tmoco.adaptive_window_pool(torch.from_numpy(x), windows))
    assert got.shape == (2, windows, 16)
    # torch's own adaptive pooling defines the bins (uneven at 32 -> 5)
    ref = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                                  (1, windows))
    # fp32 means over <= 8 x 8 values: a few ulp
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _np(ref[:, :, 0].permute(0, 2, 1)), rtol=1e-5, atol=1e-6)


def test_mlp_head_matches_jax():
    x = np.random.default_rng(2).normal(size=(6, 16)).astype(np.float32)
    jhead = jmoco.MLPHead(num_layers=3, mlp_dim=24, output_dim=8)
    params = _perturb(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(x)))
    thead = tmoco.MLPHead(3, 16, 24, 8)
    thead.load_state_dict(_mlp_head(params))
    # three small products and three batch normalisations over 6 rows
    np.testing.assert_allclose(_np(thead(torch.from_numpy(x))), want, rtol=1e-4, atol=1e-5)


def test_cross_block_matches_jax():
    """4 window queries over a 256-token map (Lq = 4: `_ref_attention`)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, 128)).astype(np.float32)
    kv = rng.normal(size=(2, 256, 128)).astype(np.float32)
    jblk = JCrossBlock(num_heads=2)
    params = _perturb(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(kv))["params"], 5)
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x), jnp.asarray(kv)))
    tblk = TCrossBlock(128, 2)
    sd = _cross_patchnet({"blocks_0": params})
    tblk.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()})
    got = _np(tblk(torch.from_numpy(x), torch.from_numpy(kv)))
    # fp32, depth-128/512 products and three normalisations: ~1e-6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_patchnet_and_pix_decoder_match_jax():
    rng = np.random.default_rng(6)
    seq = rng.normal(size=(2, 256, 128)).astype(np.float32)
    jnet = jmoco.PatchNet(embed_dim=128, num_heads=2, num_windows=4)
    params = _perturb(jnet.init(jax.random.PRNGKey(0), jnp.asarray(seq))["params"], 7)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(seq)))
    tnet = tmoco.PatchNet(128, 2, 4)
    tnet.load_state_dict(_cross_patchnet(params))
    np.testing.assert_allclose(_np(tnet(torch.from_numpy(seq))), want, rtol=1e-5, atol=1e-5)

    jdec = jmoco.PixDecoder(embed_dim=32, num_classes=48)
    params = _perturb(jdec.init(jax.random.PRNGKey(1), jnp.asarray(seq))["params"], 8)
    want = np.asarray(jdec.apply({"params": params}, jnp.asarray(seq)))
    tdec = tmoco.PixDecoder(128, 32, 48)
    tdec.load_state_dict(_pix_decoder(params))
    # depth-128 and depth-32 products, a LayerNorm and tanh GELU: ~1e-6
    np.testing.assert_allclose(_np(tdec(torch.from_numpy(seq))), want, rtol=1e-5, atol=1e-5)


def test_pretrain_encoder_with_mask_matches_jax():
    """Mask token substituted before the position table; final norm on."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, size=(2, 32, 128, 3)).astype(np.float32)
    mask = rng.random((2, 256)) < 0.7
    jenc = j_create_model("simmim_vit_micro_patch4_32x128")
    params = _perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"],
                      10)
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    tenc = t_create_model("simmim_vit_micro_patch4_32x128")
    tenc.load_state_dict(_encoder(params, 4))
    got = _np(tenc(torch.from_numpy(x), torch.from_numpy(mask)))
    # patch matmul in another flatten order + 2 blocks + final norm, fp32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    # the mask matters: unmasked differs
    assert not np.allclose(_np(tenc(torch.from_numpy(x))), got, atol=1e-3)


def test_conv_patchnet_builds_the_jax_layout():
    """`patchnet_name="conv"` builds `ConvPatchNet` (student and momentum
    copy), whose state dict `convert_torch_moco` turns into the JAX model's
    patch-extractor tree: the same leaves and shapes (the module against
    `dig_tpu`'s: tests/test_torch_port_conv_patchnet.py)."""
    name = "pretrain_simmim_moco_ori_vit_micro_patch4_32x128"
    model = t_create_model(name, patchnet_name="conv", mlp_dim=32, dim=16, num_windows=4)
    assert isinstance(model.patch_extractor, tmoco.ConvPatchNet)
    assert isinstance(model.momentum_patch_extractor, tmoco.ConvPatchNet)
    trees = convert_torch_moco({k: v.detach().numpy() for k, v in model.state_dict().items()})
    jm = j_create_model(name, patchnet_name="conv", mlp_dim=32, dim=16, num_windows=4)
    want = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, 32, 128, 3)), jnp.zeros((4, 256), bool),
                   True)["params"]["patch_extractor"]
    for tree in (trees["student"], trees["ema"]):
        got = _flat(tree["patch_extractor"])
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in
                                                         _flat(want).items()}


def test_registry_names_match_jax():
    from dig_tpu.models.registry import list_models
    from dig_tpu_torch.models.registry import _REGISTRY

    t_create_model("vit_micro_patch4_32x128")  # imports the model zoo
    wanted = [n for n in list_models() if n.startswith(("pretrain_", "simmim_vit_"))]
    assert len(wanted) == 16 and set(wanted) <= set(_REGISTRY)


# ---------------------------------------------------------------------------
# the whole model and one step
# ---------------------------------------------------------------------------

CFG = dict(img_size=(32, 128), patch_size=4, encoder_embed_dim=128, encoder_depth=2,
           encoder_num_heads=2, decoder_num_classes=48, decoder_embed_dim=192, mlp_ratio=4.0,
           qkv_bias=True, mlp_dim=96, dim=16, temperature=0.2, num_windows=4)
B = 2
LR, WD, MOM, CW = 1e-3, 0.05, 0.5, 0.1
OPT_EPS = 1e-3


def _grad_saver():
    """An optax transform that passes grads through and keeps them in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}))


@pytest.fixture(scope="module")
def jax_run():
    """JAX params (perturbed), a perturbed EMA tree, a batch, and the JAX
    step's results: one compile shared by the tests below."""
    model = jmoco.DiGPretrainModel(**CFG)
    rng = np.random.default_rng(20)
    images = rng.integers(0, 256, (B, 32, 128, 3), dtype=np.uint8)
    aug = rng.integers(0, 256, (B, 32, 128, 3), dtype=np.uint8)
    mask = np.zeros((B, 2, 256), bool)
    for r in range(B):
        for v in range(2):
            mask[r, v, rng.permutation(256)[:179]] = True
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2 * B, 32, 128, 3)),
                           jnp.zeros((2 * B, 256), bool), True)
    # a draw whose ReLU inputs sit off the kink (tests/_torch_port_pretrain_step.py)
    params = _perturb(variables["params"], 191)
    # the momentum branch perturbed away from the student, so the EMA and
    # its order before the momentum forward show in the keys and the loss
    ema = _perturb({k: params[k] for k in model.ema_submodules()}, 22)
    batch = {"images": images, "aug_images": aug, "mask": mask}
    check_relu_margin(CFG, params, ema, batch)
    total = 4
    lr = np.full(total, LR, np.float32)
    wd = np.full(total, WD, np.float32)
    tx = optax.chain(_grad_saver(), j_make_optimizer(lr, wd, eps=OPT_EPS))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = JTrainState.create(jparams, tx, ema_params=jax.tree_util.tree_map(jnp.asarray, ema))
    step = j_make_pretrain_step(model, np.full(total, MOM, np.float32),
                                np.full(total, CW, np.float32))
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(1))
    return dict(model=model, params=params, ema=ema, batch=batch, lr=lr, wd=wd,
                grads=jax.tree_util.tree_map(np.asarray, new_state.opt_state[0]["g"]),
                new_params=jax.tree_util.tree_map(np.asarray, new_state.params),
                new_ema=jax.tree_util.tree_map(np.asarray, new_state.ema_params),
                metrics={k: float(v) for k, v in metrics.items()})


def _port_model(jax_run):
    model = tmoco.DiGPretrainModel(**CFG)
    model.load_state_dict(moco_params_from_jax(jax_run["params"], jax_run["ema"]))
    return model


def test_moco_weights_roundtrip(jax_run):
    """port state_dict -> convert_torch_moco gives back the JAX trees exactly."""
    sd = _port_model(jax_run).state_dict()
    assert any(k.startswith("momentum_encoder.") for k in sd)
    back = convert_torch_moco({k: v.numpy() for k, v in sd.items()})
    for got, want in ((back["student"], jax_run["params"]), (back["ema"], jax_run["ema"])):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_model_forward_matches_jax(jax_run):
    """q1, q2, pix_pred of the student and k1, k2 of the momentum branch."""
    model, jm = _port_model(jax_run), jax_run["model"]
    rng = np.random.default_rng(23)
    x = rng.uniform(-1, 1, size=(2 * B, 32, 128, 3)).astype(np.float32)
    mask = rng.random((2 * B, 256)) < 0.7
    jout = jm.apply({"params": jax_run["params"]}, jnp.asarray(x), jnp.asarray(mask), True,
                    method=jm.forward_student)
    jk = jm.apply({"params": jax_run["ema"]}, jnp.asarray(x), jnp.asarray(mask), True,
                  method=jm.forward_key)
    with torch.no_grad():
        tout = model.forward_student(torch.from_numpy(x), torch.from_numpy(mask))
    tk = model.forward_key(torch.from_numpy(x), torch.from_numpy(mask))
    # two encoder blocks, a BN head over 8-16 rows and two cross blocks in
    # fp32; the batch normalisations over so few rows amplify rounding
    for name in ("q1", "q2", "pix_pred"):
        _close_to_max(_np(tout[name]), np.asarray(jout[name]), 1e-4)
    for got, want in zip(tk, jk):
        _close_to_max(_np(got), np.asarray(want), 1e-4)


def _run_port_step(jax_run):
    model = _port_model(jax_run)
    opt = AdamW(model.named_parameters(), jax_run["lr"], jax_run["wd"], eps=OPT_EPS)
    state = TrainState(model=model, optimizer=opt)
    step = make_pretrain_step(model, np.full(4, MOM, np.float32), np.full(4, CW, np.float32))
    state, metrics = step(state, jax_run["batch"])
    return dict(model=model, state=state, metrics={k: float(v) for k, v in metrics.items()})


_WRAPPERS = ((tattn, "attention_lse_fwd"), (tattn, "attention_lse_bwd"), (tattn, "attention_fwd"),
             (tattn, "attention_bwd"), (tln, "layer_norm_fwd"), (tln, "layer_norm_bwd"),
             (tfd, "column_sum"))


def _run_counting_calls(jax_run, env):
    """The port's step under `env`, counting the calls of every kernel
    wrapper (on the CPU each takes its plain version and counts no launch)."""
    calls = dict.fromkeys((name for _, name in _WRAPPERS), 0)

    def counting(name, real):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapper

    launches = [getattr(mod, name).launches for mod, name in _WRAPPERS]
    with pytest.MonkeyPatch.context() as mp:
        for key, value in env.items():
            mp.setenv(key, value)
        for mod, name in _WRAPPERS:
            mp.setattr(mod, name, counting(name, getattr(mod, name)))
        run = _run_port_step(jax_run)
    assert launches == [getattr(mod, name).launches for mod, name in _WRAPPERS]
    return run, calls


@pytest.fixture(scope="module")
def port_run(jax_run):
    run, calls = _run_counting_calls(jax_run, {})
    # depth 2: 2 student + 2 momentum forwards, 2 backwards; 2 x 2 norms
    assert calls == dict(attention_lse_fwd=4, attention_lse_bwd=2, attention_fwd=0,
                         attention_bwd=0, layer_norm_fwd=8, layer_norm_bwd=4, column_sum=0)
    return run


@pytest.fixture(scope="module")
def port_run_opt_in(jax_run):
    """The same step under `DIG_TPU_ATTN_STORE_LSE=0` and
    `DIG_TPU_FUSED_BIAS_GRAD=1`.  The JAX step's result serves both runs:
    off the TPU the JAX package takes `_ref_attention` and the plain column
    sum whatever its switches say."""
    run, calls = _run_counting_calls(jax_run, {"DIG_TPU_ATTN_STORE_LSE": "0",
                                               "DIG_TPU_FUSED_BIAS_GRAD": "1"})
    # the recompute pair instead of the stored-statistics one; each encoder
    # block's fc1 has 2B x 256 = 1,024 rows and takes the column sum, the
    # window extractor's (2B x 4 windows = 16 rows) the plain sum under the
    # gate, and the momentum branch runs no backward
    assert calls == dict(attention_lse_fwd=0, attention_lse_bwd=0, attention_fwd=4,
                         attention_bwd=2, layer_norm_fwd=8, layer_norm_bwd=4, column_sum=2)
    return run


def test_pretrain_step_loss_matches_jax(jax_run, port_run):
    _check_loss(jax_run, port_run)


def test_pretrain_step_loss_matches_jax_under_switches(jax_run, port_run_opt_in):
    _check_loss(jax_run, port_run_opt_in)


def _check_loss(jax_run, port_run):
    got, want = port_run["metrics"], jax_run["metrics"]
    assert sorted(got) == sorted(want) == sorted(
        ["loss", "loss_contrast", "loss_pixel", "q1_acc1", "q1_acc5", "q2_acc1", "q2_acc5",
         "grad_norm", "moco_m"])
    # fp32 through the whole graph: the losses agree to ~1e-6 relative
    for k in ("loss", "loss_contrast", "loss_pixel", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("q1_acc1", "q1_acc5", "q2_acc1", "q2_acc5", "moco_m"):
        assert got[k] == want[k], k
    assert port_run["state"].step == 1 and port_run["state"].optimizer.count == 1


def test_pretrain_step_gradients_match_jax(jax_run, port_run):
    _check_gradients(jax_run, port_run)


def test_pretrain_step_gradients_match_jax_under_switches(jax_run, port_run_opt_in):
    _check_gradients(jax_run, port_run_opt_in)


def _check_gradients(jax_run, port_run):
    """Every student gradient leaf, relative to that leaf's max |g|.  fp32
    rounding, amplified by the batch normalisations over 8-16 rows and by
    the InfoNCE softmax at T = 0.2, stays below 1e-4 of each leaf's size.
    One leaf is zero by construction -- the patch
    extractor's final LayerNorm shift, which the projection head's first
    BN removes -- and holds only rounding noise (~1e-8) on both sides:
    an absolute floor of 1e-6 of the largest gradient covers it."""
    want = moco_params_from_jax(jax_run["grads"], {})
    params = dict(port_run["model"].named_parameters())
    assert sorted(want) == sorted(n for n, p in params.items() if p.requires_grad)
    floor = 1e-6 * max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        got = params[name].grad
        assert got is not None and torch.isfinite(got).all(), name
        _close_to_max(_np(got), g.numpy(), 1e-4, floor)


def test_pretrain_step_ema_and_update_match_jax(jax_run, port_run):
    _check_ema_and_update(jax_run, port_run)


def test_pretrain_step_ema_and_update_match_jax_under_switches(jax_run, port_run_opt_in):
    _check_ema_and_update(jax_run, port_run_opt_in)


def _check_ema_and_update(jax_run, port_run):
    """The momentum branch after the EMA (m = 0.5, before its forward) and
    the parameters after one AdamW step."""
    state = port_run["model"].state_dict()
    for name, want in moco_params_from_jax({}, jax_run["new_ema"]).items():
        # the same two fp32 products and sum: equal to an ulp
        np.testing.assert_allclose(state[name].numpy(), want.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, want in moco_params_from_jax(jax_run["new_params"], {}).items():
        before = moco_params_from_jax(jax_run["params"], {})[name].numpy()
        # the update is lr * (u + wd * p) with u = m_hat / (sqrt(v_hat) + eps);
        # with eps 1e-3 a gradient difference of 1e-4 of a leaf's max moves
        # u by < 1e-3, so the step agrees to 1e-3 of lr
        np.testing.assert_allclose(state[name].numpy() - before, want.numpy() - before,
                                   rtol=0, atol=1e-3 * LR, err_msg=name)
        assert not np.array_equal(state[name].numpy(), before), name


@pytest.mark.parametrize("third", [0.0, 0.5], ids=["at_the_kink", "off_the_kink"])
def test_relu_margin_check_fires_on_a_kink(third):
    """`assert_relu_margin` on a two-layer head whose first BN normalizes
    channel 0 over the rows 1, -1 and `third`: at 0 the mean is 0 and the
    third row's ReLU input is exactly 0, which the check refuses; at 0.5
    every input sits O(1) from zero and it passes."""
    heads = [tmoco.MLPHead(2, 2, 2, 2), tmoco.MLPHead(2, 2, 2, 2, dtype=torch.float64).double()]
    for head in heads:
        with torch.no_grad():
            head[0].weight.copy_(torch.eye(2))
    x = [[1.0, 1.0], [-1.0, 2.0], [third, 4.0]]

    def forward(model):
        model(torch.tensor(x, dtype=next(model.parameters()).dtype))

    if third == 0.0:
        with pytest.raises(AssertionError, match="within the margin"):
            assert_relu_margin(*heads, forward)
    else:
        assert_relu_margin(*heads, forward)


def test_init_pretrain_state_copies_student():
    model = tmoco.build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                                       mlp_dim=32, dim=16, num_windows=4, seed=3, device="cpu")
    with torch.no_grad():
        for p in model.momentum_encoder.parameters():
            p.add_(1.0)
    state = init_pretrain_state(model, AdamW(model.named_parameters(), [1e-3]))
    for student, momentum in model.ema_submodules():
        for a, b in zip(student.parameters(), momentum.parameters()):
            assert torch.equal(a, b) and not b.requires_grad
    assert state.step == 0 and len(state.ema_modules) == 4
    same = tmoco.build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                                      mlp_dim=32, dim=16, num_windows=4, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.encoder.parameters(),
                                                 same.encoder.parameters()))


def test_build_pretrain_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises((AssertionError, RuntimeError)):
        tmoco.build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                                   mlp_dim=32, dim=16)
