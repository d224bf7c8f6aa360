"""Every recognizer kind's modules in the port against the JAX package, on
the CPU: the encoder's options, the heads' teacher-forced logits, greedy
and beam ids, the checkpoint conversions, the CTC loss and the metrics and
library losses.

The micro encoder (`vit_micro_patch4_32x128`, 2 layers, 64 wide) under
each head; the transformer decoders cut to 2 layers (`small_tf_decoder`,
the decoupled decoder built with 2 layers).  JAX parameters are
initialized, perturbed with numpy noise and carried across with
`params_from_jax`; inputs come from numpy seeds; every pass is
deterministic (dropout does not act).  Everything is fp32.  Tolerances:
logits, features and losses within 1e-5 of the reference's max |value|,
gradients within 1e-4 of each leaf's max, ids equal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_threads import one_thread
from dig_tpu.models.registry import create_model as j_create_model
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu_torch.models import decoder as tdec
from dig_tpu_torch.models.registry import create_model as t_create_model
from dig_tpu_torch.models.rec_model import build_rec_model as t_build_rec_model
from dig_tpu_torch.utils.convert import params_from_jax

B, T = 3, 25
EOS = 94
MICRO = "vit_micro_patch4_32x128"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _close_to_max(got, want, rtol, atol=0.0, what=""):
    """max |got - want| within rtol of max |want| (plus atol)."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * scale + atol, f"{what}: max abs err {err:.3e} vs max |want| {scale:.3e}"


def _perturbed(variables, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=np.shape(p)).astype(np.float32),
        variables["params"])


def _images(seed, b=B):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, 32, 128, 3)).astype(np.float32)


def _targets(seed, b=B, t=T):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 94, (b, t)).astype(np.int32),
            np.minimum(np.array([7, 25, 1][:b], np.int32), t))


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

VIT_CASES = {
    "mem_slots": dict(num_mem_slots=4),
    "mem_slots_in_decoder": dict(num_mem_slots=4, use_mem_in_decoder=True),
    "learnable_pos": dict(use_learnable_pos_emb=True),
    "pooled_mean_head": dict(return_feat_map=False, num_classes=10),
    "pooled_norm_cls": dict(return_feat_map=False, use_mean_pooling=False, num_classes=10),
    "feat_map_norm": dict(use_mean_pooling=False),
    "seq_cls_tokens": dict(use_seq_cls_token=True, max_seq_len=25),
}


@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_vision_transformer_options_match_jax(case):
    kw = VIT_CASES[case]
    jenc = j_create_model(MICRO, **kw)
    x = _images(1)
    params = _perturbed(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    tenc = t_create_model(MICRO, **kw)
    sd = {k[len("encoder."):]: v for k, v in params_from_jax({"encoder": params}).items()}
    tenc.load_state_dict(sd)  # strict: the same parameter names
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    _close_to_max(got, want, 1e-5, what=case)
    if "num_mem_slots" in kw:
        assert not tenc.mem_bank.requires_grad  # frozen: no gradient, no update


def test_memory_bank_takes_no_gradient():
    tenc = t_create_model(MICRO, num_mem_slots=4)
    tenc(torch.from_numpy(_images(3))).sum().backward()
    assert tenc.mem_bank.grad is None
    assert tenc.blocks[0].attn.qkv.weight.grad is not None


def test_registry_names_match_jax():
    from dig_tpu.models.registry import list_models
    from dig_tpu_torch.models.registry import _REGISTRY

    t_create_model(MICRO)  # imports the model zoo
    wanted = [n for n in list_models() if n.startswith("vit_")]
    assert "vit_seq_cls_base_patch4_32x128" in wanted and set(wanted) <= set(_REGISTRY)
    enc = t_create_model("vit_seq_cls_base_patch4_32x128")
    assert (enc.embed_dim, enc.depth, enc.blocks[0].attn.num_heads) == (768, 12, 12)
    assert enc.use_seq_cls_token and enc.max_seq_len == 25


# ---------------------------------------------------------------------------
# the heads of every kind
# ---------------------------------------------------------------------------

# name -> build_rec_model kwargs.  The text-conditional decoder decodes at
# max_len 8: its keys and values are [B, T, 256, C] a layer and the dense
# loops run the whole prefix at every step, so its CPU time grows as T^2.
KINDS = {
    "attn": dict(model_kind="attn"),
    "ctc": dict(model_kind="ctc"),
    "seq_cls": dict(model_kind="seq_cls"),
    "mim_rec": dict(model_kind="mim_rec", decoder_name="small_tf_decoder"),
    "mim_rec_proj": dict(model_kind="mim_rec", decoder_name="small_tf_decoder",
                         use_mim_proj=True),
    "decoupled": dict(decoder_name="decoupled_tf_decoder"),
    "text_cond": dict(decoder_name="small_tf_decoder", text_cond_vis=True, max_len=8),
    "distill": dict(decoder_name="small_tf_decoder", use_feat_distill=True),
    "distill_1d": dict(decoder_name="small_tf_decoder", use_feat_distill=True,
                       use_1d_attdec=True),
}


def _jax_model(kw):
    model = j_build_rec_model(MICRO, **kw)
    if kw.get("decoder_name") == "decoupled_tf_decoder":
        model = model.clone(decoder=model.decoder.clone(n_layers=2))
    return model


def _port_model(kw, params):
    model = t_build_rec_model(MICRO, device="cpu", **kw)
    if kw.get("decoder_name") == "decoupled_tf_decoder":
        model.decoder = tdec.DecoupledTFDecoder(97, 25, n_layers=2)
    model.load_state_dict(params_from_jax(params))
    return model


def _init(model, kind, x, targets, lens):
    key = jax.random.PRNGKey(0)
    if kind == "ctc":
        return model.init(key, x, True)
    if kind.startswith("mim_rec"):
        mask = jnp.ones((B, 256), bool)
        return model.init(key, x, targets, lens, mask, B, True)
    return model.init(key, x, targets, lens, True)


BEAM_KINDS = ["attn", "decoupled", "mim_rec", "text_cond"]


@pytest.fixture(scope="module")
def kind_pair(request):
    kind = request.param
    kw = KINDS[kind]
    x = _images(10)
    targets, lens = _targets(11, t=kw.get("max_len", T))
    jmodel = _jax_model(kw)
    params = _perturbed(_init(jmodel, kind, jnp.asarray(x), jnp.asarray(targets),
                              jnp.asarray(lens)), 12)
    if kind in ("attn", "decoupled", "text_cond", "mim_rec"):
        # EOS among the leading candidates: beams get killed, greedy stops early
        dec = params["decoder"]
        (dec["fc"] if kind == "attn" else dec["classifier"])["bias"][EOS] += (
            4.0 if kind == "decoupled" else 2.0)
    return dict(kind=kind, kw=kw, jmodel=jmodel, jparams={"params": params},
                tmodel=_port_model(kw, params), x=x, targets=targets, lens=lens)


def _jax_apply(p, *args, **kw):
    return jax.tree_util.tree_map(np.asarray, p["jmodel"].apply(p["jparams"], *args, **kw))


@pytest.mark.parametrize("kind_pair", sorted(KINDS), indirect=True)
def test_teacher_forced_outputs_match_jax(kind_pair):
    p = kind_pair
    kind, tm = p["kind"], p["tmodel"]
    x, targets, lens = (jnp.asarray(p[k]) for k in ("x", "targets", "lens"))
    tx, tt, tl = (torch.from_numpy(p[k]) for k in ("x", "targets", "lens"))
    with torch.no_grad():
        if kind == "ctc":
            want = {"logits": _jax_apply(p, x, True)}
            got = {"logits": tm(tx, deterministic=True).numpy()}
            assert got["logits"].shape == (B, 32, 98)
        elif kind.startswith("mim_rec"):
            mask = np.zeros((B, 256), bool)
            mask[:2, ::3] = True
            jout = _jax_apply(p, x, targets, lens, jnp.asarray(mask), 2, True)
            tout = tm(tx, tt.long(), tl.long(), torch.from_numpy(mask), 2, deterministic=True)
            want, got = jout, {k: v.numpy() for k, v in tout.items()}
            assert sorted(got) == ["pix_pred", "rec_pred"]
        else:
            jout = _jax_apply(p, x, targets, lens, True)
            tout = tm(tx, tt.long(), tl.long(), deterministic=True)
            names = {"decoupled": ("logits", "cls_logit", "cls_maps"),
                     "distill": ("logits", "s_feat"), "distill_1d": ("logits", "s_feat")}
            names = names.get(kind, ("logits",))
            if len(names) == 1:
                jout, tout = (jout,), (tout,)
            want = dict(zip(names, jout))
            got = {k: v.numpy() for k, v in zip(names, tout)}
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        _close_to_max(got[name], w, 1e-5, what=f"{kind} {name}")


def _recognize(p, *args, **kw):
    want = _jax_apply(p, jnp.asarray(p["x"]), *args, method=p["jmodel"].recognize, **kw)
    with torch.no_grad():
        got = p["tmodel"].recognize(torch.from_numpy(p["x"]), *args, **kw)
    return want, jax.tree_util.tree_map(lambda t: t.numpy(), got)


# CTC has no decoder (its ids are the logits' argmax); the distillation and
# mim_proj models decode as rec and mim_rec (their extras act in training only)
GREEDY_KINDS = sorted(set(KINDS) - {"ctc", "distill", "distill_1d", "mim_rec_proj"})


@pytest.mark.parametrize("kind_pair", GREEDY_KINDS, indirect=True)
def test_greedy_decode_matches_jax(kind_pair):
    """The eval step's greedy decoding (eos -1: full length): per-step
    probabilities within 1e-5, ids equal."""
    p = kind_pair
    (want_p, want_ids), (got_p, got_ids) = _recognize(p, 0, -1)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got_ids.shape == (B, p["kw"].get("max_len", T))
    _close_to_max(got_p, want_p, 1e-5, what="probs")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind_pair", BEAM_KINDS, indirect=True)
def test_beam_search_ids_match_jax(kind_pair, k):
    """Every head with a beam of its own (CTC and seq_cls decode in one
    pass; the distillation and mim_proj models decode as rec and mim_rec)."""
    p = kind_pair
    (_, want), (got_p, got) = _recognize(p, k, EOS)
    assert got_p is None and got.shape == (B, p["kw"].get("max_len", T))
    np.testing.assert_array_equal(got, want)
    assert (got == EOS).any()  # EOS was emitted: beams were killed and recovered
    if k == 1 and p["kind"] != "attn":
        # beam 1 keeps the greedy path up to its first EOS
        (_, greedy), _ = _recognize(p, 0, -1)
        for row_b, row_g in zip(got, greedy):
            stop = list(row_g).index(EOS) + 1 if EOS in row_g else len(row_g)
            np.testing.assert_array_equal(row_b[:stop], row_g[:stop])


@pytest.mark.parametrize("kind_pair", ["decoupled"], indirect=True)
def test_decoupled_greedy_early_exit_matches_jax(kind_pair):
    """Greedy with the EOS early exit: equal ids up to each row's first EOS."""
    p = kind_pair
    want_p, want_ids = _jax_apply(p, jnp.asarray(p["x"]), 0, EOS, method=p["jmodel"].recognize)
    with torch.no_grad():
        got_p, got_ids = p["tmodel"].recognize(torch.from_numpy(p["x"]), 0, EOS)
    got_ids = got_ids.numpy()
    assert (got_ids == EOS).any(axis=1).all()
    for g, w in zip(got_ids, want_ids):
        stop = list(w).index(EOS) + 1
        np.testing.assert_array_equal(g[:stop], w[:stop])


@pytest.mark.parametrize("kind_pair", ["decoupled"], indirect=True)
def test_decoupled_presence_logits_match_jax(kind_pair):
    p = kind_pair
    want = _jax_apply(p, jnp.asarray(p["x"]), 0, -1, True, method=p["jmodel"].recognize)
    with torch.no_grad():
        got = p["tmodel"].recognize(torch.from_numpy(p["x"]), 0, -1, with_cls=True)
    assert len(got) == 3 and got[2].shape == (B, 97)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    _close_to_max(got[2].numpy(), want[2], 1e-5)


def test_build_rec_model_refusals():
    with pytest.raises(ValueError, match="pretrain model"):
        t_build_rec_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                          model_kind="mim_rec", device="cpu")
    with pytest.raises(ValueError, match="requires model_kind 'rec'"):
        t_build_rec_model(MICRO, model_kind="ctc", use_feat_distill=True, device="cpu")
    with pytest.raises(ValueError, match="pretrain model"):
        j_build_rec_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                          model_kind="mim_rec")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,new,extra", [
    ((1, 64, 16), (8, 32), 0),       # 4 x 16 up to 8 x 32
    ((1, 1 + 256, 16), (4, 16), 1),  # 8 x 32 down to 4 x 16 (antialiased), one extra token
    ((1, 25 + 64, 16), (8, 32), 25),  # the seq-cls queries kept
    ((1, 1024, 16), (8, 32), 0),     # a square 32 x 32 grid
])
def test_interpolate_pos_embed_matches_jax(src, new, extra):
    from dig_tpu.utils.checkpoint import interpolate_pos_embed as j_interp
    from dig_tpu_torch.utils.checkpoint import interpolate_pos_embed as t_interp

    pos = np.random.default_rng(20).normal(size=src).astype(np.float32)
    want = j_interp(pos, new, num_extra_tokens=extra)
    got = t_interp(pos, new, num_extra_tokens=extra)
    assert got.shape == want.shape == (1, extra + new[0] * new[1], 16)
    _close_to_max(got, want, 1e-5)


def test_merge_refits_a_learnable_pos_embed_like_jax():
    """A `.pth` encoder whose pos_embed is on a 4 x 16 grid, grafted onto a
    learnable-position encoder of 8 x 32 in both packages."""
    from dig_tpu.utils.checkpoint import convert_torch_encoder as j_convert
    from dig_tpu.utils.checkpoint import merge_pretrained_encoder as j_merge
    from dig_tpu_torch.utils.checkpoint import convert_torch_encoder, merge_pretrained_tree

    rng = np.random.default_rng(21)
    sd = {"encoder.pos_embed": torch.from_numpy(rng.normal(size=(1, 64, 64)).astype(np.float32)),
          "encoder.patch_embed.proj.bias": torch.from_numpy(
              rng.normal(size=(64,)).astype(np.float32))}
    jenc = j_create_model(MICRO, use_learnable_pos_emb=True)
    jparams = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 3)))["params"]
    merged = j_merge({"encoder": jax.device_get(jparams)},
                     j_convert({k: v.numpy() for k, v in sd.items()}), pos_embed_grid=(8, 32))
    tmodel = t_build_rec_model(MICRO, "small_tf_decoder", device="cpu")
    tmodel.encoder = t_create_model(MICRO, use_learnable_pos_emb=True)
    n = merge_pretrained_tree(tmodel, {"encoder": convert_torch_encoder(sd)},
                              pos_embed_grid=(8, 32))
    assert n == 2
    _close_to_max(tmodel.encoder.pos_embed.detach().numpy(), merged["encoder"]["pos_embed"],
                  1e-5)


def _gru_state_dict(seed, c=64):
    """A reference GRU head's tensors (torch layout, separate gate biases)."""
    rng = np.random.default_rng(seed)
    shapes = {"decoder.attention_unit.sEmbed.weight": (512, 512),
              "decoder.attention_unit.sEmbed.bias": (512,),
              "decoder.attention_unit.xEmbed.weight": (512, c),
              "decoder.attention_unit.xEmbed.bias": (512,),
              "decoder.attention_unit.wEmbed.weight": (1, 512),
              "decoder.attention_unit.wEmbed.bias": (1,),
              "decoder.tgt_embedding.weight": (98, 512),
              "decoder.gru.weight_ih_l0": (3 * 512, 512 + c),
              "decoder.gru.weight_hh_l0": (3 * 512, 512),
              "decoder.gru.bias_ih_l0": (3 * 512,),
              "decoder.gru.bias_hh_l0": (3 * 512,),
              "decoder.fc.weight": (97, 512),
              "decoder.fc.bias": (97,)}
    return {"decoder." + k: torch.from_numpy((0.05 * rng.normal(size=s)).astype(np.float32))
            for k, s in shapes.items()}


def test_convert_torch_attn_head_into_both_packages():
    """A reference GRU `.pth` (nonzero hidden biases for every gate) loads
    into `dig_tpu` through its converter (r and z biases merged) and into
    the port as it is; the two heads give the same logits and ids."""
    from dig_tpu.utils.checkpoint import convert_torch_recognizer as j_convert
    from dig_tpu.utils.checkpoint import merge_pretrained_tree as j_merge
    from dig_tpu_torch.utils.checkpoint import (
        convert_torch_attn_head,
        convert_torch_recognizer,
        has_decoder_keys,
        merge_pretrained_tree,
    )

    sd = _gru_state_dict(22)
    assert has_decoder_keys(sd)
    head = convert_torch_attn_head(sd)
    assert len(head) == 13 and all(k.startswith("decoder.") for k in head)
    x, (targets, lens) = _images(23), _targets(24)
    jmodel = j_build_rec_model(MICRO, model_kind="attn")
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(targets),
                       jnp.asarray(lens), True)["params"]
    jparams = j_merge(jax.device_get(init), j_convert({k: v.numpy() for k, v in sd.items()}))
    tmodel = t_build_rec_model(MICRO, model_kind="attn", device="cpu")
    tmodel.encoder.load_state_dict({k[len("encoder."):]: v for k, v in params_from_jax(
        {"encoder": jparams["encoder"]}).items()})
    assert merge_pretrained_tree(tmodel, convert_torch_recognizer(sd)) == 13
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(targets),
                                   jnp.asarray(lens), True))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(targets).long(),
                     torch.from_numpy(lens).long(), deterministic=True).numpy()
    _close_to_max(got, want, 1e-5)


def test_transformer_decoder_pth_into_attn_head_is_refused():
    from dig_tpu_torch.utils.checkpoint import convert_torch_recognizer, merge_pretrained_tree

    rec = t_build_rec_model(MICRO, "small_tf_decoder", device="cpu")
    tree = convert_torch_recognizer(rec.state_dict())
    tree.pop("linear_norm")
    attn = t_build_rec_model(MICRO, model_kind="attn", device="cpu")
    with pytest.raises(ValueError, match="different architectures"):
        merge_pretrained_tree(attn, tree)


# ---------------------------------------------------------------------------
# CTC loss, metrics, library losses
# ---------------------------------------------------------------------------

def test_ctc_loss_and_gradient_match_optax():
    """optax's loss and its gradient, with the blank at nb_classes; row 1's
    label (25 repeats of one id: 49 frames needed, 32 given) is impossible,
    so its loss is the large finite log_epsilon case.  That row's alphas sit
    near -1e5, where one fp32 ulp is 8e-3, so both packages round its
    gradient at ~1e-2 of its size: it is held at 2e-2 of its max, the
    other rows at 1e-4 of theirs."""
    from dig_tpu_torch.losses.ctc import ctc_step_loss

    rng = np.random.default_rng(30)
    b, frames, k = 4, 32, 98
    logits = (2 * rng.normal(size=(b, frames, k))).astype(np.float32)
    targets = rng.integers(0, 94, (b, 26)).astype(np.int32)
    targets[1, :25] = 7
    lens = np.array([6, 26, 2, 13], np.int32)
    pad = (np.arange(26)[None] >= (lens - 1)[:, None]).astype(np.float32)

    def jloss(lg):
        return optax.ctc_loss(lg, jnp.zeros((b, frames)), jnp.asarray(targets),
                              jnp.asarray(pad), blank_id=97).mean()

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    per_seq = optax.ctc_loss(jnp.asarray(logits), jnp.zeros((b, frames)), jnp.asarray(targets),
                             jnp.asarray(pad), blank_id=97)
    assert float(per_seq[1]) > 1e4 and np.isfinite(np.asarray(per_seq)).all()
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_step_loss(tl, torch.from_numpy(targets).long(), torch.from_numpy(lens).long(), 97)
    got.backward()
    _close_to_max(got.item(), float(want), 1e-5)
    grad, want_grad = tl.grad.numpy(), np.asarray(want_grad)
    for row in range(b):
        _close_to_max(grad[row], want_grad[row], 2e-2 if row == 1 else 1e-4, what=f"row {row}")


def test_ctc_metrics_match_jax():
    from dig_tpu.metrics import text as jtext
    from dig_tpu.utils.charset import build_charset as j_build
    from dig_tpu_torch.metrics import text as ttext
    from dig_tpu_torch.utils.charset import build_charset as t_build

    jc, tc = j_build("ALLCASES_SYMBOLS"), t_build("ALLCASES_SYMBOLS")
    rng = np.random.default_rng(31)
    ids = rng.integers(0, 20, (12, 32))
    ids[rng.random((12, 32)) < 0.4] = tc.num_classes  # blanks
    ids[::3, 5:9] = 11  # repeats
    ids[1::4, 3] = tc.eos_id
    ids[2, 10] = tc.padding_id
    targets = np.full((12, 25), tc.padding_id)
    for i, text in enumerate(ttext.ctc_decode_batch(ids, tc)):
        word = text if i % 2 else text[:-1]
        row = [tc.classes.index(ch) for ch in word] + [tc.eos_id]
        targets[i, :len(row)] = row
    assert ttext.ctc_decode_batch(ids, tc) == jtext.ctc_decode_batch(ids, jc)
    acc = ttext.ctc_accuracy(ids, targets, tc)
    assert acc == jtext.ctc_accuracy(ids, targets, jc) and 0 < acc < 1


def test_multi_label_f_measure_matches_jax():
    from dig_tpu.metrics.text import multi_label_f_measure as j_f
    from dig_tpu_torch.metrics.text import multi_label_f_measure as t_f

    rng = np.random.default_rng(32)
    logits = rng.normal(size=(8, 97)).astype(np.float32)
    targets = (rng.random((8, 97)) < 0.2).astype(np.float32)
    assert t_f(logits, targets) == j_f(logits, targets)
    assert 0 < t_f(logits, targets) < 1


def test_seq_simclr_loss_matches_jax():
    from dig_tpu.losses.simclr import seq_simclr_loss as j_loss
    from dig_tpu_torch.losses.simclr import seq_simclr_loss as t_loss

    rng = np.random.default_rng(33)
    zi, zj = (rng.normal(size=(4, 256, 32)).astype(np.float32) for _ in range(2))
    want = float(j_loss(jnp.asarray(zi), jnp.asarray(zj), 0.2, 5))
    got = t_loss(torch.from_numpy(zi), torch.from_numpy(zj), 0.2, 5).item()
    _close_to_max(got, want, 1e-5)


def test_dino_loss_matches_jax():
    from dig_tpu.losses.extra import dino_loss as j_loss
    from dig_tpu_torch.losses.extra import dino_loss as t_loss

    rng = np.random.default_rng(34)
    s, t = (rng.normal(size=(6, 40)).astype(np.float32) for _ in range(2))
    center = rng.normal(size=(1, 40)).astype(np.float32)
    jl, jc = j_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(center))
    tl, tc = t_loss(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(center))
    _close_to_max(tl.item(), float(jl), 1e-5)
    _close_to_max(tc.numpy(), np.asarray(jc), 1e-5)


def test_sinkhorn_matches_jax():
    from dig_tpu.losses.extra import sinkhorn as j_sinkhorn
    from dig_tpu_torch.losses.extra import sinkhorn as t_sinkhorn

    scores = np.random.default_rng(35).normal(size=(10, 7)).astype(np.float32)
    want = np.asarray(j_sinkhorn(jnp.asarray(scores)))
    got = t_sinkhorn(torch.from_numpy(scores)).numpy()
    _close_to_max(got, want, 1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("use_sinkhorn,use_entropy", [(True, False), (False, True)])
def test_msn_loss_matches_jax(use_sinkhorn, use_entropy):
    from dig_tpu.losses.extra import msn_loss as j_loss
    from dig_tpu_torch.losses.extra import msn_loss as t_loss

    rng = np.random.default_rng(36)
    a, t = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    protos = rng.normal(size=(5, 16)).astype(np.float32)
    jl, jm = j_loss(jnp.asarray(a), jnp.asarray(t), jnp.asarray(protos),
                    use_sinkhorn=use_sinkhorn, use_entropy=use_entropy)
    tl, tm = t_loss(torch.from_numpy(a), torch.from_numpy(t), torch.from_numpy(protos),
                    use_sinkhorn=use_sinkhorn, use_entropy=use_entropy)
    _close_to_max(tl.item(), float(jl), 1e-5)
    for k in ("msn_ce", "msn_rloss"):
        _close_to_max(tm[k].item(), float(jm[k]), 1e-5, what=k)
