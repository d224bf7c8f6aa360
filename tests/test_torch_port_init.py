"""The port's random initial weights against the JAX package's, on the CPU.

The parity tests hand both packages the same weights, so they cannot see a
difference in how each package draws its initial weights; a long training
run can (the window extractor's MLP of the pre-training model; the
embeddings of the GRU head and of the decoupled decoder's order).  Here
the CLIs' own `build_model` functions initialise both packages' models of
every kind, and every parameter of at least two dimensions must have the spread of its JAX
counterpart (`utils/convert.py::jax_leaf`): its standard deviation within
10% where it holds at least 1,000 values (a sample's spread is then within
~2% of the distribution's), equal where the JAX leaf is a constant."""

import numpy as np
import pytest
from _torch_port_threads import one_thread

from dig_tpu_torch.utils.convert import jax_leaf


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


PRETRAIN = ["--model", "pretrain_simmim_moco_ori_vit_micro_patch4_32x128", "--moco_mlp_dim",
            "256", "--moco_dim", "64", "--dtype", "float32"]
KINDS = {
    "pretrain": PRETRAIN,
    "rec": ["--model", "vit_micro_patch4_32x128", "--decoder_name", "small_tf_decoder",
            "--dtype", "float32"],
    "ctc": ["--model", "vit_micro_patch4_32x128", "--model_kind", "ctc", "--dtype", "float32"],
    "attn": ["--model", "vit_micro_patch4_32x128", "--model_kind", "attn", "--dtype", "float32"],
    "decoupled": ["--model", "vit_micro_patch4_32x128", "--decoder_name",
                  "decoupled_tf_decoder", "--dtype", "float32"],
    "mim_rec": ["--model", "vit_micro_patch4_32x128", "--decoder_name", "small_tf_decoder",
                "--model_kind", "mim_rec", "--dtype", "float32"],
    "text_cond": ["--model", "vit_micro_patch4_32x128", "--decoder_name", "small_tf_decoder",
                  "--text_cond_vis", "--dtype", "float32"],
    "seq_cls": ["--model", "vit_seq_cls_base_patch4_32x128", "--decoder_name",
                "small_tf_decoder", "--use_seq_cls_token", "--dtype", "float32"],
}


def _jax_params(kind, argv):
    import jax
    import optax

    import dig_tpu.config as jcfg

    if kind == "pretrain":
        from dig_tpu.cli.run_pretrain import build_model
        from dig_tpu.train.pretrain import init_pretrain_state

        model = build_model(jcfg.parse_config(jcfg.PretrainConfig, argv))
        state = init_pretrain_state(model, optax.sgd(0.1), jax.random.PRNGKey(0))
    else:
        from dig_tpu.cli.run_finetune import build_model
        from dig_tpu.train.finetune import init_finetune_state

        cfg = jcfg.parse_config(jcfg.FinetuneConfig, argv)
        state = init_finetune_state(build_model(cfg), optax.sgd(0.1), jax.random.PRNGKey(0),
                                    model_kind=cfg.model_kind)
    return jax.tree_util.tree_map(np.asarray, state.params)


def _port_params(kind, argv):
    from dig_tpu_torch import config

    if kind == "pretrain":
        from dig_tpu_torch.cli.run_pretrain import build_model

        cfg = config.parse_config(config.PretrainConfig, argv)
    else:
        from dig_tpu_torch.cli.run_finetune import build_model

        cfg = config.parse_config(config.FinetuneConfig, argv)
    model = build_model(cfg, "cpu")
    # the momentum branch starts as a copy of the student in both packages
    return {k: p.detach().numpy() for k, p in model.named_parameters()
            if not k.startswith(("momentum_", "pix_projector_m"))}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_initial_weights_have_the_jax_spread(kind):
    jax_params = _jax_params(kind, KINDS[kind])
    checked, bad = 0, {}
    for key, value in _port_params(kind, KINDS[kind]).items():
        if value.ndim < 2:
            continue
        path, _, _, _ = jax_leaf(key, value.shape)
        ref = jax_params
        for k in path:
            ref = ref[k]
        if ref.std() == 0:
            if not (value.std() == 0 and value.mean() == ref.mean()):
                bad[key] = (float(value.mean()), float(ref.mean()))
        elif value.size >= 1000:
            if abs(value.std() / ref.std() - 1) > 0.1:
                bad[key] = (float(value.std()), float(ref.std()))
        else:
            continue
        checked += 1
    assert checked > 10 and not bad, bad
