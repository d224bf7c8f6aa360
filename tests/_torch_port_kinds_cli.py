"""Shared fixtures of the port's CLI tests for every model kind
(test_torch_port_kinds_finetune_cli.py, test_torch_port_kinds_aux_cli.py):
seeded labelled LMDBs, the JAX initial weights of a kind, and both
fine-tuning CLIs run from them.

The micro encoder in fp32, every encoder rate 0 and the decoders'
hard-coded dropout 0 on both sides (torch and JAX random streams cannot
match), no augmentation, one loader thread.  The JAX CLI initializes its
model from `--seed`; the port's `build_model` is wrapped to load those same
weights (`params_from_jax`).  The JAX CLI runs on the test harness's 8 CPU
devices at batch 1 a device, the port at batch 8 on one: the same global
batch and learning rate; 32 training records make 4 steps an epoch."""

import json
import os
import signal
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dig_tpu.cli import run_finetune as jcli
from dig_tpu.config import FinetuneConfig as JFinetuneConfig
from dig_tpu.config import parse_config as j_parse_config
from dig_tpu.train.finetune import init_finetune_state as j_init_finetune_state
from dig_tpu_torch.cli import run_finetune as tcli
from dig_tpu_torch.config import FinetuneConfig, parse_config
from dig_tpu_torch.data.lmdb_store import LmdbWriter
from dig_tpu_torch.ops import activations as tact
from dig_tpu_torch.utils.charset import build_charset
from dig_tpu_torch.utils.convert import params_from_jax

MICRO = "vit_micro_patch4_32x128"
N_TRAIN, N_EVAL = 32, 13
GLOBAL_BATCH = 8
EOS = 94
RECIPE = ["--epochs", "1", "--lr", "0.032", "--opt_eps", "1e-3", "--drop", "0",
          "--attn_drop_rate", "0", "--drop_path", "0", "--no_use_abi_aug", "--num_view", "1",
          "--num_workers", "1", "--dtype", "float32", "--seed", "0", "--warmup_epochs", "0"]


def png(img):
    """RGB [H, W, 3] -> PNG bytes (cv2 writes BGR; the datasets decode to RGB)."""
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def write_lmdb(path, images, words):
    with LmdbWriter(str(path)) as w:
        for i, (img, word) in enumerate(zip(images, words), start=1):
            w.put(b"image-%09d" % i, png(img))
            w.put(b"label-%09d" % i, word.encode())
        w.put(b"num-samples", str(len(words)).encode())


def make_data(root):
    """Train and eval LMDBs of seeded images and random words."""
    charset = build_charset("ALLCASES_SYMBOLS", 25)
    rng = np.random.default_rng(0)
    out = {}
    for name, n in (("train", N_TRAIN), ("eval", N_EVAL)):
        images = [rng.integers(0, 256, (32, 128, 3), dtype=np.uint8) for _ in range(n)]
        words = ["".join(charset.classes[j] for j in rng.integers(0, EOS, rng.integers(1, 6)))
                 for _ in range(n)]
        write_lmdb(root / name, images, words)
        out[name] = str(root / name)
    return out


def jax_init_params(argv):
    """The parameters the JAX CLI starts from under these flags."""
    cfg = j_parse_config(JFinetuneConfig, argv)
    state = j_init_finetune_state(jcli.build_model(cfg), optax.identity(),
                                  jax.random.PRNGKey(cfg.seed), max_len=cfg.max_len,
                                  model_kind=cfg.model_kind)
    return jax.tree_util.tree_map(np.asarray, state.params)


def zero_decoder_dropout(mp, params):
    """Both CLIs build their decoders at dropout 0; the port's model loads
    the JAX initial weights `params`."""
    real_t, real_j = tcli.build_model, jcli.build_model

    def port_build(cfg, device, use_feat_distill=None):
        model = real_t(cfg, device, use_feat_distill)
        for m in model.modules():
            if hasattr(m, "dropout") and isinstance(m.dropout, float):
                m.dropout = 0.0
        sd = params_from_jax(params)
        if use_feat_distill is False:  # the teacher: no projector
            sd = {k: v for k, v in sd.items() if not k.startswith("feat_proj.")}
        model.load_state_dict(sd)
        return model

    def jax_build(cfg):
        model = real_j(cfg)
        if "decoder" in model.__dataclass_fields__:  # the transformer decoders
            model = model.clone(decoder=model.decoder.clone(dropout=0.0))
        return model

    mp.setattr(tcli, "build_model", port_build)
    mp.setattr(jcli, "build_model", jax_build)


def run_jax(argv):
    """`dig_tpu.cli.run_finetune.main`, with stdout, the signal handlers and
    the GELU form put back afterwards (the JAX CLI leaves them set)."""
    from dig_tpu.ops import activations as jact

    stdout, exact = sys.stdout, jact.EXACT
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return jcli.main(j_parse_config(JFinetuneConfig, argv))
    finally:
        tee, sys.stdout = sys.stdout, stdout
        if tee is not stdout:
            tee.file.close()
        for s, h in handlers.items():
            signal.signal(s, h)
        jact.set_exact(exact)


def read_log(out):
    with open(os.path.join(str(out), "log.txt")) as f:
        return [json.loads(line) for line in f]


def run_both(root, data, argv, jax_argv=(), port_argv=(), patch=None):
    """Both CLIs, one epoch of 4 steps from the JAX initial weights; `patch(mp)`
    adds monkeypatches.  Returns (JAX log, port log, port screen)."""
    n_dev = jax.device_count()
    assert GLOBAL_BATCH % n_dev == 0
    base = ["--model", MICRO] + RECIPE + ["--data_path", data["train"]] + list(argv)
    params = jax_init_params(base)
    exact = tact.EXACT
    with pytest.MonkeyPatch.context() as mp:
        zero_decoder_dropout(mp, params)
        if patch is not None:
            patch(mp)
        run_jax(base + list(jax_argv) + ["--batch_size", str(GLOBAL_BATCH // n_dev),
                                         "--output_dir", str(root / "jax")])
        tcli.main(parse_config(FinetuneConfig, base + list(port_argv) + [
            "--batch_size", str(GLOBAL_BATCH), "--output_dir", str(root / "port")]),
            device="cpu")
    tact.set_exact(exact)
    return (read_log(root / "jax"), read_log(root / "port"),
            (root / "port" / "screen.txt").read_text())


def assert_train_logs_match(jlog, tlog):
    """Epoch averages of the first and last step's metrics: fp32 through the
    whole graph, within 1e-4 relative; the batch accuracy equal."""
    assert len(jlog) == len(tlog) == 1
    jl, tl = jlog[0], tlog[0]
    keys = sorted(k for k in jl if k.startswith("train_"))
    assert keys and keys == sorted(k for k in tl if k.startswith("train_"))
    for k in keys:
        assert np.isfinite(tl[k]), k
        if k == "train_class_acc":
            assert tl[k] == jl[k]
        else:
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, err_msg=k)
