"""`dig_tpu_torch.tools.export_pth` (and `utils/export_torch.py`) against
`dig_tpu`'s exporter, on the CPU.

The same tiny `dig_tpu` parameters (perturbed from their init by numpy
noise) go three ways to a `.pth`: `tools/export_pth.py` (JAX) on the
native directory `dig_tpu.utils.checkpoint.save_checkpoint` writes; the
port's tool on that same native directory; and the port's tool on a port
checkpoint of the converted weights.  All three give the same keys and
`torch.equal` tensors, for the recognizer with a transformer decoder, the
GRU attention head, the decoupled decoder (its multi-label head not
exported), a pre-training checkpoint's encoder (`--encoder_only`) and its
momentum encoder (`--ema`).  The heads `dig_tpu` refuses are refused here
too.  Then the exported `.pth`, read back through the port's `--finetune`
surgery, recognises with the ids of the model it came from."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.models import moco as jmoco
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.optim import create_optimizer as j_create_optimizer
from dig_tpu.train.finetune import init_finetune_state as j_init_finetune_state
from dig_tpu.train.pretrain import init_pretrain_state as j_init_pretrain_state
from dig_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from dig_tpu_torch.cli.run_finetune import load_finetune_init
from dig_tpu_torch.config import FinetuneConfig, parse_config
from dig_tpu_torch.models.moco import DiGPretrainModel
from dig_tpu_torch.models.rec_model import build_rec_model
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.optim import create_optimizer
from dig_tpu_torch.tools import export_pth
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils.checkpoint import save_checkpoint
from dig_tpu_torch.utils.convert import moco_params_from_jax, params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRE_KW = dict(img_size=(32, 128), patch_size=4, encoder_embed_dim=64, encoder_depth=2,
              encoder_num_heads=2, mlp_dim=32, dim=16, num_windows=4)
# kind -> (model kind, decoder name)
RECOGNIZERS = {"rec": ("rec", "small_tf_decoder"), "attn": ("attn", "small_tf_decoder"),
               "decoupled": ("rec", "decoupled_tf_decoder"), "ctc": ("ctc", "small_tf_decoder")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    """tools/export_pth.py, the JAX package's tool, as a module."""
    spec = importlib.util.spec_from_file_location("jax_export_pth",
                                                  os.path.join(ROOT, "tools", "export_pth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["export_pth.py", *argv])
    _jax_tool().main()


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.normal(size=np.shape(x))
                              .astype(np.asarray(x).dtype)), tree)


def _as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recognizer(kind, root):
    """A native directory of `kind`'s perturbed JAX parameters, and a port
    checkpoint directory of the same weights; (native, port, port model)."""
    model_kind, decoder = RECOGNIZERS[kind]
    jm = j_build_rec_model("vit_micro_patch4_32x128", decoder, model_kind=model_kind)
    tx = j_create_optimizer("adamw", np.full(4, 1e-3, np.float32))
    state = j_init_finetune_state(jm, tx, jax.random.PRNGKey(1), model_kind=model_kind)
    state = state.replace(params=_perturb(state.params, 4))
    native = j_save_checkpoint(str(root / "native"), 1, state)
    model = build_rec_model("vit_micro_patch4_32x128", decoder, model_kind=model_kind,
                            device="cpu")
    model.load_state_dict(params_from_jax(_as_np(state.params)))
    port_state = TrainState(model=model, optimizer=create_optimizer(
        "adamw", model.named_parameters(), [1e-3]), step=1)
    return native, save_checkpoint(str(root / "port"), 1, port_state), model


def _pretrain(root):
    jm = jmoco.DiGPretrainModel(**PRE_KW)
    tx = j_create_optimizer("adamw", np.full(4, 1e-3, np.float32), np.full(4, 0.05, np.float32))
    state = j_init_pretrain_state(jm, tx, jax.random.PRNGKey(0))
    state = state.replace(params=_perturb(state.params, 5),
                          ema_params=_perturb(state.ema_params, 6))
    native = j_save_checkpoint(str(root / "native"), 3, state)
    model = DiGPretrainModel(**PRE_KW)
    model.load_state_dict(moco_params_from_jax(_as_np(state.params), _as_np(state.ema_params)))
    port_state = TrainState(model=model, optimizer=create_optimizer(
        "adamw", model.named_parameters(), [1e-3]), step=3)
    return native, save_checkpoint(str(root / "port"), 3, port_state), model


def _three_routes(native, port, flags, tmp_path, monkeypatch):
    """The .pth of each route: the JAX tool, the port's tool on the native
    directory, the port's tool on the port checkpoint."""
    out = {}
    for name, argv in (("jax", [native]), ("port_native", [native]), ("port", [port])):
        path = str(tmp_path / f"{name}.pth")
        if name == "jax":
            _run_jax_tool([*argv, path, *flags], monkeypatch)
        else:
            export_pth.main([*argv, path, *flags])
        out[name] = torch.load(path, weights_only=True)["model"]
    return out


def _assert_same(routes):
    want = routes["jax"]
    assert want
    for name, got in routes.items():
        assert sorted(got) == sorted(want), (name, set(got) ^ set(want))
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (name, k)


@pytest.mark.parametrize("kind", ["rec", "attn", "decoupled"])
def test_recognizer_export_equals_dig_tpu(kind, tmp_path, monkeypatch):
    native, port, _ = _recognizer(kind, tmp_path)
    routes = _three_routes(native, port, [], tmp_path, monkeypatch)
    _assert_same(routes)
    assert not any(k.startswith("multi_label.") for k in routes["port"])
    if kind == "attn":  # flax's one r / z bias: zeros in bias_hh's first two thirds
        hh = routes["port"]["decoder.decoder.gru.bias_hh_l0"]
        assert not hh[: 2 * hh.shape[0] // 3].any()


@pytest.mark.parametrize("flags", [["--encoder_only"], ["--encoder_only", "--ema"]],
                         ids=["encoder", "ema_encoder"])
def test_pretrain_encoder_export_equals_dig_tpu(flags, tmp_path, monkeypatch):
    native, port, model = _pretrain(tmp_path)
    routes = _three_routes(native, port, flags, tmp_path, monkeypatch)
    _assert_same(routes)
    source = model.momentum_encoder if "--ema" in flags else model.encoder
    got = routes["port"]
    assert "encoder.mask_token" in got
    for k, v in source.state_dict().items():
        assert torch.equal(got["encoder." + k], v), k


@pytest.mark.parametrize("case", ["ctc", "pretrain_whole", "rec_ema"])
def test_refusals_match_dig_tpu(case, tmp_path, monkeypatch):
    """CTC's head and a whole pre-training model have no reference layout:
    both tools raise ValueError; --ema on a recognizer exits in both."""
    if case == "ctc":
        native, port, _ = _recognizer("ctc", tmp_path)
    elif case == "pretrain_whole":
        native, port, _ = _pretrain(tmp_path)
    else:
        native, port, _ = _recognizer("rec", tmp_path)
    flags = ["--ema"] if case == "rec_ema" else []
    error = SystemExit if case == "rec_ema" else ValueError
    with pytest.raises(error):
        _run_jax_tool([native, str(tmp_path / "j.pth"), *flags], monkeypatch)
    for path in (native, port):
        with pytest.raises(error):
            export_pth.main([path, str(tmp_path / "p.pth"), *flags])


def _ids(model, seed=9):
    images = np.random.default_rng(seed).integers(0, 256, (4, 32, 128, 3), dtype=np.uint8)
    with torch.no_grad():
        return model.recognize(to_model_images(torch.from_numpy(images)))[1]


@pytest.mark.parametrize("kind", ["rec", "attn"])
def test_exported_pth_finetunes_to_the_same_ids(kind, tmp_path):
    """The port's export, read back by `--finetune` into a recognizer of
    another seed, decodes as the source model does (greedy ids)."""
    _, port, source = _recognizer(kind, tmp_path)
    pth = str(tmp_path / "export.pth")
    export_pth.main([port, pth])
    model_kind, decoder = RECOGNIZERS[kind]
    cfg = parse_config(FinetuneConfig, ["--model", "vit_micro_patch4_32x128", "--decoder_name",
                                        decoder, "--model_kind", model_kind, "--finetune", pth])
    fresh = build_rec_model("vit_micro_patch4_32x128", decoder, model_kind=model_kind, seed=7,
                            device="cpu")
    load_finetune_init(cfg, fresh)
    assert torch.equal(_ids(fresh.eval()), _ids(source.eval()))


def test_pretrain_encoder_pth_finetunes_as_its_directory(tmp_path):
    """An encoder-only export of a port pre-training checkpoint initializes
    a recognizer exactly as `--finetune` of the directory does."""
    _, port, _ = _pretrain(tmp_path)
    pth = str(tmp_path / "enc.pth")
    export_pth.main([port, pth, "--encoder_only"])
    models = []
    for source in (port, pth):
        cfg = parse_config(FinetuneConfig, ["--model", "vit_micro_patch4_32x128",
                                            "--decoder_name", "small_tf_decoder",
                                            "--finetune", source])
        model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", seed=7,
                                device="cpu")
        load_finetune_init(cfg, model)
        models.append(model.eval())
    a, b = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(_ids(models[0]), _ids(models[1]))
