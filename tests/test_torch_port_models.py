"""Models of the PyTorch port (`dig_tpu_torch.models`) against the JAX
package, with the JAX weights carried across by `params_from_jax`, and the
weight layout in both directions.

JAX parameters are initialized and then perturbed with numpy noise so that
biases, norm scales and shifts are all non-trivial.  Everything runs in
fp32 on the CPU; each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.models.decoder import create_decoder as j_create_decoder
from dig_tpu.models.layers import Block as JBlock
from dig_tpu.models.registry import create_model as j_create_model
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.utils.checkpoint import convert_torch_recognizer
from dig_tpu.utils.export_torch import export_torch_recognizer
from dig_tpu_torch.models.decoder import create_decoder as t_create_decoder
from dig_tpu_torch.models.layers import Block as TBlock
from dig_tpu_torch.models.rec_model import build_rec_model as t_build_rec_model
from dig_tpu_torch.models.registry import create_model as t_create_model
from dig_tpu_torch.utils.convert import (
    _encoder,
    block_from_jax,
    decoder_from_jax,
    params_from_jax,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.normal(size=np.shape(p)).astype(np.float32), tree)


def _np(t):
    return t.detach().numpy()


def test_block_matches_jax():
    """One ViT block at width 128, 2 heads x 64, 128 tokens, batch 4: the
    port's LayerNorm gate (512 rows) and attention gate (L = 128) both pass,
    so its wrappers run their plain versions; the JAX CPU path runs
    `_ln_ref` and `_ref_attention`."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 128, 128)).astype(np.float32)
    jblk = JBlock(num_heads=2, qkv_bias=True)
    params = _perturb(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    tblk = TBlock(128, 2, qkv_bias=True)
    tblk.load_state_dict(block_from_jax(params))
    with torch.no_grad():
        got = _np(tblk(torch.from_numpy(x)))
    # fp32, three products of depth <= 512 and two normalisations: ~1e-6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_micro_vit_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(2, 32, 128, 3)).astype(np.float32)
    jenc = j_create_model("vit_micro_patch4_32x128", return_feat_map=True)
    params = _perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    tenc = t_create_model("vit_micro_patch4_32x128")
    tenc.load_state_dict(_encoder(params, 4))
    with torch.no_grad():
        got = _np(tenc(torch.from_numpy(x)))
    assert got.shape == (2, 256, 64)
    # patch matmul in another flatten order + 2 blocks, fp32: ~1e-6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.fixture(scope="module")
def small_decoder():
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(3, 256, 384)).astype(np.float32)
    targets = rng.integers(0, 97, size=(3, 25)).astype(np.int32)
    lens = np.array([25, 7, 1], np.int32)
    jdec = j_create_decoder("small_tf_decoder", 97, 25)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(enc), jnp.asarray(targets),
                       jnp.asarray(lens), True)["params"]
    params = _perturb(params, 5)
    tdec = t_create_decoder("small_tf_decoder", 97, 25)
    tdec.load_state_dict(decoder_from_jax(params))
    return jdec, params, tdec, enc, targets, lens


def test_small_decoder_teacher_forced_matches_jax(small_decoder):
    jdec, params, tdec, enc, targets, lens = small_decoder
    want = np.asarray(jdec.apply({"params": params}, jnp.asarray(enc), jnp.asarray(targets),
                                 jnp.asarray(lens), True))
    with torch.no_grad():
        got = _np(tdec(torch.from_numpy(enc), torch.from_numpy(targets).long(),
                       torch.from_numpy(lens).long(), deterministic=True))
    # fp32 logits of a 2-layer decoder, masked softmax: ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_small_decoder_greedy_matches_jax(small_decoder):
    jdec, params, tdec, enc, _, _ = small_decoder
    jp, jids = jdec.apply({"params": params}, jnp.asarray(enc), method=jdec.greedy_decode)
    with torch.no_grad():
        tp, tids = tdec.greedy_decode(torch.from_numpy(enc))
    # the KV-cached loop on both sides: same ids, fp32 probabilities
    np.testing.assert_array_equal(_np(tids), np.asarray(jids))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def micro_rec_params():
    model = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3)),
                           jnp.zeros((2, 25), jnp.int32), jnp.ones((2,), jnp.int32), True)
    return model, _perturb(variables["params"], 6)


def test_params_from_jax_equals_export_torch(micro_rec_params):
    """The port's importer writes the same keys and values as the JAX
    package's reference-layout exporter."""
    _, params = micro_rec_params
    got = params_from_jax(params)
    want = export_torch_recognizer(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)


def test_port_state_dict_round_trips_into_jax_tree(micro_rec_params):
    """port.state_dict() -> convert_torch_recognizer == the JAX tree, leaf
    by leaf and bit for bit; the port loads the JAX weights strictly."""
    _, params = micro_rec_params
    port = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    tree = convert_torch_recognizer({k: _np(v) for k, v in port.state_dict().items()})
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,width,depth", [
    ("vit_micro_patch4_32x128", 64, 2), ("vit_tiny_patch4_32x128", 192, 12),
    ("vit_small_patch4_32x128", 384, 12), ("vit_base_patch4_32x128", 512, 12)])
def test_registry_widths(name, width, depth):
    enc = t_create_model(name)
    j = j_create_model(name)
    assert (enc.embed_dim, len(enc.blocks)) == (width, depth) == (j.embed_dim, j.depth)
    assert enc.blocks[0].attn.num_heads == j.num_heads


@pytest.mark.parametrize("name", ["tf_decoder", "small_tf_decoder", "corres_tiny_tf_decoder",
                                  "corres_small_tf_decoder", "corres_base_tf_decoder"])
def test_decoder_factory_shapes(name):
    t = t_create_decoder(name, 97, 25)
    j = j_create_decoder(name, 97, 25)
    assert (len(t.layer_stack), t.d_embedding, t.n_head, t.d_k) == \
        (j.n_layers, j.d_embedding, j.n_head, j.d_k)
    assert t.trg_word_emb.weight.shape == (98, j.d_embedding)  # BOS is id 97
    assert t.layer_stack[0].mlp.w_1.out_features == j.d_inner


def test_layernorm_eps_is_flax_default():
    """Every LayerNorm of the port uses flax's eps 1e-6, not torch's 1e-5."""
    from dig_tpu_torch.models.layers import FusedLayerNorm, LayerNorm

    model = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cpu")
    norms = [m for m in model.modules() if isinstance(m, (LayerNorm, FusedLayerNorm))]
    assert len(norms) == 2 * 2 + 1 + 2 * 3 + 1
    assert all(m.eps == 1e-6 for m in norms)
    assert not any(isinstance(m, (torch.nn.LayerNorm, torch.nn.Conv2d)) for m in model.modules())


def test_random_init_is_seeded():
    a = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=3, device="cpu")
    b = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=3, device="cpu")
    c = t_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.blocks.0.attn.qkv.weight"],
                           sc["encoder.blocks.0.attn.qkv.weight"])
