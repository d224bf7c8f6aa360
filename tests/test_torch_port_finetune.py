"""The port's fine-tuning step, eval step and their pieces against the JAX
package, on the CPU; dropout and drop-path on their own terms.

JAX parameters of a micro recognizer (`vit_micro_patch4_32x128` +
`small_tf_decoder`) are initialized, perturbed with numpy noise and
carried across with `params_from_jax`; inputs come from numpy seeds.  The
JAX fine-tuning step always trains with dropout on (`finetune.py:58-60`)
and its decoder hard-codes dropout 0.1, so both sides run with every rate
at 0 (the JAX decoder cloned at dropout 0 here): torch and JAX random
streams cannot match.  At batch 2 the encoder has 512 LayerNorm rows and
L = 256, so the port's CPU path goes through the kernel-pair autograd
Functions.  Everything is fp32; each tolerance is stated where it is
used."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dig_tpu.losses import seq_ce as jce
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.optim import create_optimizer as j_create_optimizer
from dig_tpu.optim import frozen_encoder_mask as j_frozen_encoder_mask
from dig_tpu.optim import layer_scales as j_layer_scales
from dig_tpu.train.finetune import make_eval_step as j_make_eval_step
from dig_tpu.train.finetune import make_finetune_step as j_make_finetune_step
from dig_tpu.train.state import TrainState as JTrainState
from dig_tpu_torch import optim as toptim
from dig_tpu_torch.losses import seq_ce as tce
from dig_tpu_torch.models import layers as tlayers
from dig_tpu_torch.models.rec_model import build_rec_model as t_build_rec_model
from dig_tpu_torch.train.finetune import (
    init_finetune_state,
    make_eval_step,
    make_finetune_step,
)
from dig_tpu_torch.utils.convert import params_from_jax

B = 2
LR, WD, OPT_EPS = 1e-3, 0.05, 1e-3
LAYER_DECAY, FROZEN = 0.75, 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy()


def _close_to_max(got, want, rtol, atol=0.0):
    """max |got - want| within rtol of max |want| (plus atol)."""
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= rtol * scale + atol, f"max abs err {err:.3e} vs max |want| {scale:.3e}"


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


def _decoder_dropout_off(model):
    """The counterpart of the JAX `decoder.clone(dropout=0.0)`: each
    decoder module reads its rate at every call."""
    for m in model.decoder.modules():
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    return model


def _port_model(params):
    model = _decoder_dropout_off(t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder",
                                                   device="cpu"))
    model.load_state_dict(params_from_jax(params))
    return model


def _port_optimizer(model):
    return toptim.create_optimizer(
        "adamw", model.named_parameters(), np.full(4, LR, np.float32),
        np.full(4, WD, np.float32), eps=OPT_EPS, layer_decay=LAYER_DECAY, num_layers=2,
        frozen=toptim.frozen_encoder_mask(FROZEN))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX fine-tuning step (rates 0, layer decay 0.75, one frozen
    encoder block) and eval step on perturbed micro weights: one compile
    each, shared by the tests below."""
    model = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    model = model.clone(decoder=model.decoder.clone(dropout=0.0))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((B, 32, 128, 3)),
                           jnp.zeros((B, 25), jnp.int32), jnp.ones((B,), jnp.int32), True)
    rng = np.random.default_rng(40)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p)).astype(np.float32),
        variables["params"])
    tx = optax.chain(_grad_saver(), j_create_optimizer(
        "adamw", np.full(4, LR, np.float32), np.full(4, WD, np.float32), eps=OPT_EPS,
        layer_decay=LAYER_DECAY, num_layers=2, frozen=j_frozen_encoder_mask(FROZEN)))
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    batch = _batch(41)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, metrics, pred_ids = j_make_finetune_step(model, smoothing=0.1)(
        state, jbatch, jax.random.PRNGKey(1))
    eval_ids, eval_loss = j_make_eval_step(model)(jax.tree_util.tree_map(jnp.asarray, params),
                                                  jbatch)
    return dict(params=params, batch=batch,
                grads=jax.tree_util.tree_map(np.asarray, new_state.opt_state[0]["g"]),
                new_params=jax.tree_util.tree_map(np.asarray, new_state.params),
                metrics={k: float(v) for k, v in metrics.items()},
                pred_ids=np.asarray(pred_ids), eval_ids=np.asarray(eval_ids),
                eval_loss=np.asarray(eval_loss))


@pytest.fixture(scope="module")
def port_run(jax_run):
    model = _port_model(jax_run["params"])
    state = init_finetune_state(model, _port_optimizer(model))
    step = make_finetune_step(model, smoothing=0.1)
    state, metrics, pred_ids = step(state, jax_run["batch"], torch.Generator().manual_seed(0))
    return dict(model=model, state=state, metrics={k: float(v) for k, v in metrics.items()},
                pred_ids=pred_ids)


def test_finetune_step_loss_matches_jax(jax_run, port_run):
    got, want = port_run["metrics"], jax_run["metrics"]
    assert sorted(got) == sorted(want) == ["grad_norm", "loss"]
    # fp32 through the encoder, the decoder and a 97-way log-softmax
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    np.testing.assert_array_equal(_np(port_run["pred_ids"]), jax_run["pred_ids"])
    assert port_run["state"].step == 1 and port_run["state"].optimizer.count == 1


def test_finetune_step_gradients_match_jax(jax_run, port_run):
    """Every gradient leaf, relative to that leaf's max |g|: fp32 rounding
    in another order stays below 1e-4 of each leaf's size; a floor of 1e-6
    of the largest gradient covers leaves that are near zero by
    construction."""
    want = params_from_jax(jax_run["grads"])
    params = dict(port_run["model"].named_parameters())
    assert sorted(want) == sorted(params)
    floor = 1e-6 * max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        got = params[name].grad
        assert got is not None and torch.isfinite(got).all(), name
        _close_to_max(_np(got), g.numpy(), 1e-4, floor)


def test_finetune_step_update_matches_jax(jax_run, port_run):
    """The AdamW update with layer-wise lr decay 0.75 and the embeddings
    and first block frozen: frozen tensors keep their values exactly, the
    others move as in the JAX package."""
    state = port_run["model"].state_dict()
    before = params_from_jax(jax_run["params"])
    frozen = toptim.frozen_encoder_mask(FROZEN)
    for name, want in params_from_jax(jax_run["new_params"]).items():
        if frozen(name):
            assert torch.equal(state[name], before[name]) and torch.equal(want, before[name]), name
            continue
        # the update is lr * scale * (u + wd * p), u = m_hat / (sqrt(v_hat) + eps);
        # with eps 1e-3 a gradient difference of 1e-4 of a leaf's max moves
        # u by < 1e-3, so the step agrees to 1e-3 of lr
        np.testing.assert_allclose(_np(state[name] - before[name]), _np(want - before[name]),
                                   rtol=0, atol=1e-3 * LR, err_msg=name)
        assert not torch.equal(state[name], before[name]), name


def test_eval_step_matches_jax(jax_run):
    """Greedy ids at full length and the per-row CE of log(probs + 1e-9)."""
    ids, loss = make_eval_step(_port_model(jax_run["params"]))(jax_run["batch"])
    np.testing.assert_array_equal(_np(ids), jax_run["eval_ids"])
    assert loss.shape == (B,)
    # sums of 25 fp32 log-probabilities: ~1e-6 relative
    np.testing.assert_allclose(_np(loss), jax_run["eval_loss"], rtol=1e-5)


def test_layer_scales_and_frozen_mask_match_jax(jax_run):
    """The port's per-name lr scales and frozen predicate against the JAX
    trees, leaf by leaf (carried across as constant arrays)."""
    params = jax_run["params"]
    as_leaves = lambda tree: params_from_jax(jax.tree_util.tree_map(
        lambda s, p: np.full(np.shape(p), s, np.float32), tree, params))
    want_scales = as_leaves(j_layer_scales(params, LAYER_DECAY, 2))
    frozen = j_frozen_encoder_mask(FROZEN)
    want_frozen = as_leaves(jax.tree_util.tree_map_with_path(
        lambda path, p: float(frozen(path, p)), params))
    got_scales = toptim.layer_scales(list(want_scales), LAYER_DECAY, 2)
    got_frozen = toptim.frozen_encoder_mask(FROZEN)
    assert len(set(got_scales.values())) == 4  # embeddings, 2 blocks, the rest
    for name in want_scales:
        assert float(want_scales[name].flatten()[0]) == pytest.approx(got_scales[name], rel=1e-6)
        assert bool(want_frozen[name].flatten()[0]) == got_frozen(name), name


@pytest.mark.parametrize("fn,kw", [
    ("seq_cross_entropy", {}),
    ("seq_cross_entropy", {"sequence_normalize": True, "sample_normalize": False}),
    ("seq_cross_entropy_rows", {}),
    ("seq_label_smoothing_cross_entropy", {"smoothing": 0.1}),
    ("seq_label_smoothing_cross_entropy",
     {"smoothing": 0.2, "sequence_normalize": True, "sample_normalize": False}),
])
def test_seq_ce_matches_jax(fn, kw):
    rng = np.random.default_rng(42)
    logits = (3 * rng.normal(size=(4, 25, 97))).astype(np.float32)
    targets = rng.integers(0, 97, (4, 25)).astype(np.int32)
    lengths = np.array([25, 1, 9, 0], np.int32)
    want = np.asarray(getattr(jce, fn)(jnp.asarray(logits), jnp.asarray(targets),
                                       jnp.asarray(lengths), **kw))
    got = getattr(tce, fn)(torch.from_numpy(logits), torch.from_numpy(targets),
                           torch.from_numpy(lengths), **kw)
    # fp32 log-softmax over 97 classes, summed over <= 100 tokens
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)


def test_text_metrics_match_jax():
    from dig_tpu.metrics import text as jtext
    from dig_tpu.utils.charset import build_charset as j_build
    from dig_tpu_torch.metrics import text as ttext
    from dig_tpu_torch.utils.charset import build_charset as t_build

    jc, tc = j_build("ALLCASES_SYMBOLS"), t_build("ALLCASES_SYMBOLS")
    rng = np.random.default_rng(43)
    preds = rng.integers(0, 40, (16, 25))
    preds[:, 6] = tc.eos_id
    targs = preds.copy()
    targs[::3, 2] = 45  # a symbol the normalization keeps differs in some rows
    targs[1::4, 6:8] = [30, tc.eos_id]  # one more character in others
    assert ttext.decode_batch(preds, tc) == jtext.decode_batch(preds, jc)
    assert ttext.accuracy(preds, targs, tc) == jtext.accuracy(preds, targs, jc)
    assert 0 < ttext.accuracy(preds, targs, tc) < 1
    assert ttext.edit_distance(preds, targs, tc) == jtext.edit_distance(preds, targs, jc) > 0
    for a, b in (("", "abc"), ("kitten", "sitting"), ("same", "same")):
        assert ttext.levenshtein(a, b) == jtext.levenshtein(a, b)


def test_finetune_config_matches_jax():
    from dig_tpu.config import FinetuneConfig as J
    from dig_tpu.config import parse_config as j_parse
    from dig_tpu_torch.config import FinetuneConfig as T
    from dig_tpu_torch.config import parse_config as t_parse

    fields = lambda cls: [(f.name, f.default if f.default is not dataclasses.MISSING
                           else f.default_factory()) for f in dataclasses.fields(cls)]
    assert fields(T) == fields(J)
    argv = ["--batch_size", "64", "--layer_decay", "0.75", "--clip_grad", "3.0",
            "--opt_betas", "0.9", "0.98", "--fixed_encoder_layers", "2", "--no_use_abi_aug",
            "--data_path", "a", "b"]
    t, j = t_parse(T, argv).finalize(4), j_parse(J, argv).finalize(4)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.absolute_lr == j.absolute_lr == 1e-4 * 64 * 4 / 256


STILL_REFUSED = {
    # every optimizer name of dig_tpu runs (test_torch_port_optimizers.py);
    # a name it does not know is refused, as dig_tpu refuses it
    "opt": (lambda m: toptim.create_optimizer("lamb_x", m.named_parameters(), [1e-3]),
            ValueError, "Invalid optimizer 'lamb_x'"),
    # every model kind and decoder runs; distillation needs the
    # rec model's projector, which the CTC and the decoupled models lack
    "model_kind": (lambda m: t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder",
                                               model_kind="ctc", use_feat_distill=True,
                                               device="cpu"), ValueError, "ctc"),
    "decoupled_decoder": (lambda m: t_build_rec_model("vit_micro_patch4_32x128",
                                                      "decoupled_tf_decoder",
                                                      use_feat_distill=True, device="cpu"),
                          ValueError, "decoupled"),
}


@pytest.mark.parametrize("what", sorted(STILL_REFUSED))
def test_unported_options_are_refused(what):
    """What the port does not run is refused by name; gradient
    accumulation and beam search, once refused, now run
    (test_torch_port_finetune_cli.py, test_torch_port_decode.py)."""
    model = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    call, exc, word = STILL_REFUSED[what]
    with pytest.raises(exc, match=word):
        call(model)
    toptim.create_optimizer("adamw", model.named_parameters(), [1e-3], update_freq=2)
    make_eval_step(model, beam_width=3)


# ---------------------------------------------------------------------------
# dropout and drop-path, on their own terms
# ---------------------------------------------------------------------------

RATES = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)


def _forward(model, batch, **kw):
    images = torch.from_numpy(batch["images"]).float() / 127.5 - 1
    return model(images, torch.from_numpy(batch["targets"]).long(),
                 torch.from_numpy(batch["lengths"]).long(), **kw)


def test_rates_zero_equal_the_deterministic_pass():
    model = _decoder_dropout_off(t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder",
                                                   seed=1, device="cpu"))
    batch = _batch(44)
    with torch.no_grad():
        train = _forward(model, batch, generator=torch.Generator().manual_seed(0))
        det = _forward(model, batch, deterministic=True)
    assert torch.equal(train, det)


def test_dropout_masks_follow_the_generator_only():
    """The same seed gives the same pass, another seed another one; a
    training pass needs a generator; the deterministic pass differs."""
    model = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=1, device="cpu",
                              **RATES)
    batch = _batch(45)
    with torch.no_grad():
        a = _forward(model, batch, generator=torch.Generator().manual_seed(0))
        b = _forward(model, batch, generator=torch.Generator().manual_seed(0))
        c = _forward(model, batch, generator=torch.Generator().manual_seed(1))
        det = _forward(model, batch, deterministic=True)
        with pytest.raises(ValueError, match="generator"):
            _forward(model, batch)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, det)


def test_dropout_keeps_one_minus_rate_scaled_exactly():
    x = torch.from_numpy(np.random.default_rng(46).normal(size=(64, 1000)).astype(np.float32))
    rate, n = 0.1, x.numel()
    y = tlayers.dropout(x, rate, torch.Generator().manual_seed(2))
    kept = y != 0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 4 * sigma
    assert torch.equal(y[kept], (x / (1 - rate))[kept])
    assert tlayers.dropout(x, rate, None) is x


def test_drop_path_drops_whole_samples():
    x = torch.from_numpy(np.random.default_rng(47).normal(size=(64, 5, 7)).astype(np.float32))
    y = tlayers.drop_path(x, 0.5, torch.Generator().manual_seed(3))
    zero = (y == 0).flatten(1).all(1)
    scaled = (y == x / 0.5).flatten(1).all(1)
    assert torch.all(zero ^ scaled) and zero.any() and scaled.any()


def test_attention_dropout_takes_the_unfused_path(monkeypatch):
    """Under attention dropout a training pass never reaches the kernel
    pair; the deterministic pass does."""
    calls = []
    real = tlayers.multi_head_attention_qkv
    monkeypatch.setattr(tlayers, "multi_head_attention_qkv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=1, device="cpu",
                              **RATES)
    batch = _batch(48)
    with torch.no_grad():
        _forward(model, batch, generator=torch.Generator().manual_seed(0))
        assert calls == []
        _forward(model, batch, deterministic=True)
    assert len(calls) == 2


def test_embedding_matches_torch_forward_and_backward():
    """The decoder's char embedding: torch's rows, and its gradient summed
    in a one-hot product (another order: fp32 rounding apart)."""
    rng = np.random.default_rng(50)
    w = torch.from_numpy(rng.normal(size=(98, 32)).astype(np.float32)).requires_grad_()
    w2 = w.detach().clone().requires_grad_()
    ids = torch.from_numpy(rng.integers(0, 98, (8, 25)))
    go = torch.from_numpy(rng.normal(size=(8, 25, 32)).astype(np.float32))
    out = tlayers.embedding(w, ids)
    assert torch.equal(out, torch.nn.functional.embedding(ids, w2))
    out.backward(go)
    torch.nn.functional.embedding(ids, w2).backward(go)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-6, atol=1e-6)


def test_finetune_step_leaves_the_global_rng_alone():
    model = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=1, device="cpu",
                              **RATES)
    state = init_finetune_state(model, toptim.create_optimizer(
        "adamw", model.named_parameters(), [1e-3], [0.05]))
    rng_state = torch.random.get_rng_state()
    state, metrics, _ = make_finetune_step(model)(state, _batch(49),
                                                  torch.Generator().manual_seed(0))
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
