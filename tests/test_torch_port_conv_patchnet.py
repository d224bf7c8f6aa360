"""`--patchnet_name conv` in the port (`ConvPatchNet`) against `dig_tpu`'s,
on the CPU.

The module alone on the same weights (`convert.moco_params_from_jax` /
`_conv_patchnet`) and inputs, in fp32: its batch statistics are over
B x H x W rows per channel, then over B rows in its head, so it is held at
1e-4 of the output's largest value.  One whole pre-training step with the
conv extractor (model and tolerances: tests/_torch_port_pretrain_step.py).
Then the micro CLI run that tests/test_variant_and_mesh_invariance.py runs
for `dig_tpu` (`test_pretrain_cli_conv_patchnet`), on the port."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_pretrain_step import check_against_jax, close_to_max, jax_step, perturb, port_step
from dig_tpu.models import moco as jmoco
from dig_tpu.utils.checkpoint import convert_torch_moco
from dig_tpu_torch.cli.run_pretrain import main
from dig_tpu_torch.config import PretrainConfig
from dig_tpu_torch.data.lmdb_store import LmdbWriter
from dig_tpu_torch.models import moco as tmoco
from dig_tpu_torch.utils.convert import _conv_patchnet


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("windows", [4, 5])
def test_conv_patchnet_module_matches_jax(windows):
    d = 32
    jm = jmoco.ConvPatchNet(embed_dim=d, num_windows=windows, patch_shape=(8, 32))
    rng = np.random.default_rng(40 + windows)
    x = rng.normal(size=(6, 256, d)).astype(np.float32)
    params = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 41)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tmoco.ConvPatchNet(d, windows, (8, 32))
    tm.load_state_dict(_conv_patchnet(params))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (6, 1, d)
    close_to_max(got.detach().numpy(), want, 1e-4)
    # the layout is the reference's: dig_tpu's converter reads it back exactly
    back = convert_torch_moco({f"patch_extractor.{k}": v.numpy()
                               for k, v in tm.state_dict().items()})["student"]
    flat = lambda t, p="": {k2: v2 for k, v in t.items()  # noqa: E731
                            for k2, v2 in (flat(v, f"{p}{k}/") if isinstance(v, dict)
                                           else {p + k: np.asarray(v)}).items()}
    got_tree, want_tree = flat(back["patch_extractor"]), flat(params)
    assert sorted(got_tree) == sorted(want_tree)
    for k in want_tree:
        np.testing.assert_array_equal(got_tree[k], want_tree[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_conv():
    # one global vector an image: 6 keys for InfoNCE's top-5 accuracy
    return jax_step(6, patchnet_name="conv")


def test_conv_patchnet_step_matches_jax(jax_conv):
    run = port_step(jax_conv, patchnet_name="conv")
    # the conv extractor runs no kernel: the encoder's counts are the plain step's
    assert run["calls"] == dict(attention_lse_fwd=4, attention_lse_bwd=2, layer_norm_fwd=8,
                                layer_norm_bwd=4)  # 2 x 6 x 256 rows: a multiple of 512
    assert any(n.startswith("momentum_patch_extractor.conv_layers") for n in run["params"])
    check_against_jax(jax_conv, run)


def test_pretrain_cli_conv_patchnet(tmp_path):
    """`run_pretrain.main` with `--patchnet_name conv` on the micro model,
    as `dig_tpu`'s test runs it: 8 JPEGs, one epoch, fp32, a global batch of
    8 (`dig_tpu` takes batch 1 on each of the harness's 8 devices; the port
    runs one device, and InfoNCE's top-5 accuracy needs 5 keys: one a
    conv-extracted image)."""
    rng = np.random.default_rng(0)
    lmdb_path = str(tmp_path / "lmdb")
    with LmdbWriter(lmdb_path) as w:
        for i in range(1, 9):
            img = rng.integers(0, 255, size=(32, 100, 3), dtype=np.uint8)
            ok, buf = cv2.imencode(".jpg", img)
            assert ok
            w.put(b"image-%09d" % i, buf.tobytes())
            w.put(b"label-%09d" % i, b"word")
        w.put(b"num-samples", b"8")
    out = str(tmp_path / "out")
    state = main(PretrainConfig(
        model="pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
        image_alone_path=[lmdb_path], batch_size=8, epochs=1,
        warmup_steps=2, moco_mlp_dim=32, moco_dim=16, num_windows=4,
        num_workers=2, output_dir=out, dtype="float32",
        patchnet_name="conv",
    ), device="cpu")
    assert any(d.startswith("checkpoint-") for d in os.listdir(out))
    assert state.step == 1
    assert isinstance(state.model.patch_extractor, tmoco.ConvPatchNet)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
