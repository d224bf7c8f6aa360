"""The port's sharding rules against the JAX package's, leaf by leaf.

`dig_tpu_torch.parallel.mesh.fsdp_param_shardings` and
`tp_param_shardings` (and their composition, ``base=``) must split the same
leaves along the same axes as `dig_tpu.parallel.mesh`'s rules do on the JAX
tree, on the conftest's 8-device CPU mesh (2 x 2 x 2), for the trees that
tests/test_tp_rules.py enumerates: the micro pre-training model (its
momentum branch at its place in the EMA tree, whose specs are the
student's) and the recognizer vit_micro + small_tf_decoder.  Each port
parameter is mapped to its JAX leaf by `utils.convert.jax_leaf`, which is
first held to the converters themselves: a JAX tree of distinct values
goes through `params_from_jax` / `moco_params_from_jax` and every >= 2-D
port tensor must hold its JAX leaf's values, along the axes `jax_leaf`
names.  The port's ``parts`` (q, k and v split apart) is a layout of the
piece, not another axis: the placement compared is (mesh axis, dim).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_threads import one_thread
from dig_tpu.models.moco import DiGPretrainModel as JPretrainModel
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.parallel.mesh import create_mesh as j_create_mesh
from dig_tpu.parallel.mesh import fsdp_param_shardings as j_fsdp
from dig_tpu.parallel.mesh import tp_param_shardings as j_tp
from dig_tpu_torch.models.moco import DiGPretrainModel
from dig_tpu_torch.models.rec_model import build_rec_model
from dig_tpu_torch.parallel.mesh import (
    REPLICATED,
    fsdp_param_shardings,
    param_shardings,
    tp_param_shardings,
)
from dig_tpu_torch.utils.convert import jax_leaf, moco_params_from_jax, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# tests/test_tp_rules.py's trees
PRE_CFG = dict(img_size=(32, 128), patch_size=4, encoder_embed_dim=64, encoder_depth=2,
               encoder_num_heads=2, decoder_num_classes=48, decoder_embed_dim=32, mlp_dim=128,
               dim=32, num_windows=4, qkv_bias=True, use_pixel_target=True,
               use_moco_target=True)


@pytest.fixture(scope="module")
def mesh():
    return j_create_mesh(n_data=2, n_fsdp=2, n_tensor=2, devices=jax.devices()[:8])


def _pretrain_trees():
    jm = JPretrainModel(**PRE_CFG)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 128, 3), jnp.float32),
                jnp.zeros((2, 256), bool), True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    ema = {k: params[k] for k in jm.ema_submodules() if k in params}
    return params, ema, DiGPretrainModel(**PRE_CFG)


def _rec_trees():
    jm = j_build_rec_model(model_name="vit_micro_patch4_32x128",
                           decoder_name="small_tf_decoder", nb_classes=12, max_len=5)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 3)), jnp.zeros((1, 5), jnp.int32),
                jnp.full((1,), 5), True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return params, None, build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder",
                                         nb_classes=12, max_len=5, device="cpu")


@pytest.fixture(scope="module", params=["pretrain", "recognizer"])
def trees(request):
    """(JAX params, JAX EMA tree or None, the port's model of the same config)."""
    return _pretrain_trees() if request.param == "pretrain" else _rec_trees()


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_placement(key, shape, shardings):
    """A JAX spec of the leaf behind port parameter `key` as a port
    (mesh axis, dim)."""
    if len(shape) < 2:  # both rules replicate a 1-D leaf
        return (None, None)
    path, _, to_port, _ = jax_leaf(key, shape)
    spec = _at(shardings, path).spec
    for axis, name in enumerate(spec):
        if name is not None:
            return (name, to_port[axis])
    return (None, None)


def _port_placements(placements):
    return {k: (p.mesh_axis, p.dim) for k, p in placements.items()}


def _check(model, params, ema, port, jax_shardings):
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = {k: _jax_placement(k, s, jax_shardings) for k, s in shapes.items()}
    got = _port_placements(port)
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    return sum(1 for v in got.values() if v[0] is not None)


def test_jax_leaf_reads_the_converters_backwards(trees):
    """Every >= 2-D port parameter holds the values of the JAX leaf that
    `jax_leaf` names: along its axes where they map one to one, as a set
    where the port flattens or concatenates them."""
    params, ema, model = trees
    rng = np.random.default_rng(0)
    # distinct values a leaf, exact in float32
    counter = iter(range(1, 10**6))
    probe = jax.tree_util.tree_map(
        lambda x: (rng.permutation(x.size).reshape(x.shape) + 1.0e4 * next(counter)).astype(
            np.float32), params)
    if ema is None:
        sd = params_from_jax(probe)
    else:
        sd = moco_params_from_jax(probe, {k: probe[k] for k in ema})
    checked = 0
    for key, p in model.named_parameters():
        if p.dim() < 2:
            continue
        path, jshape, to_port, parts = jax_leaf(key, p.shape)
        leaf = _at(probe, path)
        assert tuple(leaf.shape) == jshape, (key, leaf.shape, jshape)
        got = sd[key].numpy()
        if None in to_port or parts > 1:
            assert set(np.unique(leaf)) <= set(np.unique(got)), key
        else:
            order = [to_port.index(d) for d in range(len(to_port))]
            np.testing.assert_array_equal(got, np.transpose(leaf, order), err_msg=key)
        checked += 1
    assert checked >= 20


@pytest.mark.parametrize("rule", ["fsdp", "fsdp_min_size_1", "tp", "tp_over_fsdp"])
def test_rules_shard_the_leaves_dig_tpu_shards(rule, trees, mesh):
    params, ema, model = trees
    min_size = 1 if rule in ("fsdp_min_size_1", "tp_over_fsdp") else 2**16
    j_base = j_fsdp(mesh, params, min_size=min_size)
    if rule.startswith("fsdp"):
        port, jax_s = fsdp_param_shardings(model, 2, min_size), j_base
    elif rule == "tp":
        port, jax_s = tp_param_shardings(model, 2), j_tp(mesh, params)
    else:
        port = tp_param_shardings(model, 2, base=fsdp_param_shardings(model, 2, min_size))
        jax_s = j_tp(mesh, params, base=j_base)
        assert port == param_shardings(model, 2, 2, min_size)
    n = _check(model, params, ema, port, jax_s)
    if rule != "fsdp":
        assert n >= 10, n


def test_fsdp_tie_break_on_a_square_kernel(mesh):
    """proj [C, C]: flax's kernel splits along its axis 0 (argmax takes the
    first of a tie), which is torch's axis 1; the fused qkv [3C, C] along its
    largest axis, torch's 0."""
    model = DiGPretrainModel(**PRE_CFG)
    port = fsdp_param_shardings(model, 2, min_size=1)
    assert port["encoder.blocks.0.attn.proj.weight"].dim == 1
    assert port["momentum_encoder.blocks.0.attn.proj.weight"].dim == 1
    assert port["encoder.blocks.0.attn.qkv.weight"].dim == 0
    assert port["encoder.blocks.0.attn.q_bias"] == REPLICATED  # 1-D: never sharded
    tp = tp_param_shardings(model, 2)
    assert tp["encoder.blocks.0.attn.qkv.weight"].parts == 3  # whole heads a rank
    assert tp["encoder.blocks.0.attn.proj.weight"].dim == 1  # row-parallel: torch's in
    # the window extractor's cross-attention: column-split q/k/v, no row rule for proj
    assert tp["patch_extractor.blocks.0.attn.linear_q.weight"].dim == 0
    assert tp["patch_extractor.blocks.0.attn.proj.weight"] == REPLICATED
