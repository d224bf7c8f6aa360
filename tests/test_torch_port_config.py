"""The port's config parser against the JAX package's: the reference CLIs'
flag spellings (`--use_cls`, `--decoder_type`, `--use_seq_cls_token`,
`--moco_m_cos`) must land on the same fields for all three configs,
`config_to_json` must be strict JSON, and what `--use_cls` selects (the
encoder's final norm) must be built and loaded."""

import dataclasses
import json

import pytest
import torch

import dig_tpu.config as jcfg
import dig_tpu_torch.config as tcfg

CONFIGS = ["PredictConfig", "PretrainConfig", "FinetuneConfig"]
# each reference spelling, alone and among other flags, in both forms of a
# valued flag; the classes that lack a spelling's target field must pass it
# on to "unknown flags" exactly as the JAX parser does
ARGVS = [
    [],
    ["--use_cls"],
    ["--use_cls", "--model_kind", "ctc"],
    ["--decoder_type", "tf_decoder"],
    ["--decoder_type", "attention"],
    ["--decoder_type=attention", "--batch_size", "7"],
    ["--use_seq_cls_token"],
    ["--use_seq_cls_token", "False"],
    ["--use_seq_cls_token", "true", "--max_len", "30"],
    ["--use_seq_cls_token=yes"],
    ["--moco_m_cos"],
    ["--moco_m", "0.996", "--moco_m_cos"],
    ["--decoder_type", "attention", "--model_kind", "rec"],  # a later explicit flag wins
    ["--batch_size", "12", "--lr", "3e-4", "--opt_betas", "0.8", "0.95", "--bogus", "1"],
    ["--decoder_type", "tf_decoder", "--use_cls", "--moco_m_cos", "--seed", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
@pytest.mark.parametrize("name", CONFIGS)
def test_parse_config_matches_jax_on_reference_spellings(name, argv, capsys):
    want = jcfg.parse_config(getattr(jcfg, name), list(argv))
    j_out = capsys.readouterr().out
    got = tcfg.parse_config(getattr(tcfg, name), list(argv))
    t_out = capsys.readouterr().out
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert {k: type(v) for k, v in dataclasses.asdict(got).items()} == \
           {k: type(v) for k, v in dataclasses.asdict(want).items()}
    assert t_out == j_out  # the same translations and unknown flags reported


def test_use_cls_selects_the_final_norm_in_both():
    """The fault this pins: `--use_cls` once fell to "unknown flags" in the
    port and left `use_mean_pooling=True`."""
    for name in ("PredictConfig", "FinetuneConfig"):
        got = tcfg.parse_config(getattr(tcfg, name), ["--use_cls"])
        assert got.use_mean_pooling is False
        assert jcfg.parse_config(getattr(jcfg, name), ["--use_cls"]).use_mean_pooling is False
    assert tcfg.parse_config(tcfg.PredictConfig, ["--decoder_type", "attention"]).model_kind == "attn"
    assert tcfg.parse_config(tcfg.PredictConfig, ["--use_seq_cls_token"]).model_kind == "seq_cls"
    assert tcfg.parse_config(tcfg.PretrainConfig, ["--moco_m_cos"]).use_moco_m_cos is True


@pytest.mark.parametrize("name", ["PredictConfig", "FinetuneConfig"])
def test_bogus_decoder_type_raises_in_both(name):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError, match="tf_decoder"):
            mod.parse_config(getattr(mod, name), ["--decoder_type=bogus"])
        with pytest.raises(ValueError, match="tf_decoder"):
            mod.parse_config(getattr(mod, name), ["--decoder_type"])
    # a class without model_kind passes the spelling on untouched
    assert dataclasses.asdict(tcfg.parse_config(tcfg.PretrainConfig, ["--decoder_type=bogus"])) == \
        dataclasses.asdict(jcfg.parse_config(jcfg.PretrainConfig, ["--decoder_type=bogus"]))


def _no_constants(name):
    raise AssertionError(f"config_to_json printed the bare constant {name}")


@pytest.mark.parametrize("name", CONFIGS)
def test_config_to_json_is_strict_json_and_equals_jax(name):
    text = tcfg.config_to_json(getattr(tcfg, name)())
    parsed = json.loads(text, parse_constant=_no_constants)  # no Infinity / NaN
    assert text == jcfg.config_to_json(getattr(jcfg, name)())
    inf_fields = [f.name for f in dataclasses.fields(getattr(tcfg, name))
                  if f.default == float("inf")]
    assert all(parsed[k] == "inf" for k in inf_fields)
    if name != "PredictConfig":
        assert inf_fields  # num_samples / aloneimage_num_samples


def test_int_fields_are_coerced_as_in_jax():
    argv = ["--batch_size", "16", "--max_len", "30"]
    got = tcfg.parse_config(tcfg.FinetuneConfig, argv)
    assert type(got.batch_size) is int and type(got.max_len) is int
    assert type(got.auto_resume) is bool  # a bool is not coerced to int


def test_use_cls_state_dict_loads_with_its_final_norm():
    """A recognizer trained with `--use_cls` carries `encoder.norm.*`; with
    the flag parsed the port builds that norm, so the state dict loads with
    nothing missing and nothing unexpected.  Without the flag the same keys
    are unexpected, which is what the CLI reported and ignored before."""
    from dig_tpu_torch.cli.run_predict import load_model

    base = ["--model", "vit_micro_patch4_32x128", "--decoder_name", "small_tf_decoder",
            "--dtype", "float32"]
    with_cls = load_model(tcfg.parse_config(tcfg.PredictConfig, base + ["--use_cls"]), "cpu")
    sd = with_cls.state_dict()
    assert {"encoder.norm.weight", "encoder.norm.bias"} <= set(sd)
    sd = {k: torch.full_like(v, 0.5) for k, v in sd.items()}
    missing, unexpected = with_cls.load_state_dict(sd, strict=False)
    assert missing == [] and unexpected == []
    assert float(with_cls.encoder.norm.weight.detach().mean()) == 0.5
    # the norm is applied: features differ from the same weights without it
    without = load_model(tcfg.parse_config(tcfg.PredictConfig, base), "cpu")
    missing, unexpected = without.load_state_dict(sd, strict=False)
    assert missing == [] and sorted(unexpected) == ["encoder.norm.bias", "encoder.norm.weight"]
    x = torch.zeros(1, 32, 128, 3)
    assert not torch.allclose(with_cls.encoder(x), without.encoder(x))


@pytest.mark.parametrize("kind", ["attn", "seq_cls", "ctc"])
def test_build_rec_model_refuses_model_kinds_it_cannot_run(kind):
    """Every kind builds; what a kind cannot run is feature distillation,
    whose projector lives on the `rec` model only (as `dig_tpu` refuses it)."""
    from dig_tpu_torch.models.rec_model import build_rec_model

    build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", model_kind=kind, device="cpu")
    with pytest.raises(ValueError, match=kind):
        build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", model_kind=kind,
                        use_feat_distill=True, device="cpu")
