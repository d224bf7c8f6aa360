"""Configurations with the JAX package's flag names: batch inference
(`PredictConfig`), pre-training (`PretrainConfig`) and fine-tuning
(`FinetuneConfig`).

`PredictConfig` has the fields and defaults of `dig_tpu.config.PredictConfig`
so that a command line written for `dig_tpu.cli.run_predict` parses the
same here, the reference CLIs' own spellings included (`--use_cls`,
`--decoder_type`, `--use_seq_cls_token`, `--moco_m_cos`: see
`_REF_FLAG_ALIASES`).  `--n_fsdp` / `--n_tensor` lay the ranks out as the
JAX package's (data, fsdp, tensor) mesh (`parallel/mesh.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Tuple


@dataclasses.dataclass
class PredictConfig:
    # model (must match the checkpoint)
    model: str = "vit_small_patch4_32x128"
    decoder_name: str = "tf_decoder"
    model_kind: str = "rec"  # rec | ctc | attn | seq_cls
    use_1d_attdec: bool = False
    use_mean_pooling: bool = True
    text_cond_vis: bool = False
    nb_classes: int = 97
    max_len: int = 25
    voc_type: str = "ALLCASES_SYMBOLS"
    beam_width: int = 0
    # inference is deterministic; rates exist only for flag compatibility
    drop: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path: float = 0.0
    use_feat_distill: bool = False
    exact_gelu: Optional[bool] = None  # None = auto (erf for .pth weights)
    # weights: --resume = a native dig_tpu or a port checkpoint directory;
    # --finetune = reference-layout .pth
    resume: str = ""
    finetune: str = ""
    model_key: str = "model|module"
    model_prefix: str = ""
    # input: files / directories / globs, and-or LMDBs (labels ignored)
    images: List[str] = dataclasses.field(default_factory=list)
    data_path: List[str] = dataclasses.field(default_factory=list)
    input_h: int = 32
    input_w: int = 128
    batch_size: int = 512
    num_workers: int = 4
    # output: TSV ``name\ttext\tconfidence`` (stdout when empty)
    output: str = ""
    seed: int = 0
    dtype: str = "bfloat16"


_TRUTHY = ("1", "true", "yes", "on")


def _add_field_args(parser: argparse.ArgumentParser, cfg) -> None:
    for f in dataclasses.fields(cfg):
        name = "--" + f.name
        default = getattr(cfg, f.name)
        if isinstance(default, bool):
            group = parser.add_mutually_exclusive_group()
            group.add_argument(name, dest=f.name, action="store_true", default=default)
            group.add_argument("--no_" + f.name, dest=f.name, action="store_false",
                               default=default)
        elif "bool" in str(f.type):  # tri-state Optional[bool] (None = auto)
            parser.add_argument(name, default=default,
                                type=lambda s: s.lower() in _TRUTHY)
        elif isinstance(default, (list, tuple)) or "List" in str(f.type) or "Tuple" in str(f.type):
            parser.add_argument(name, nargs="*", default=default)
        elif isinstance(default, float) or default is None:
            parser.add_argument(name, type=float, default=default)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def _map_decoder_type(val):
    # the reference builds RecModel for tf_decoder, AttnRecModel for
    # attention, and raises for anything else
    kind = {"tf_decoder": "rec", "attention": "attn"}.get(val or "")
    if not kind:
        raise ValueError(
            f"--decoder_type {val!r}: the reference supports tf_decoder "
            "or attention (run_class_finetuning.py:350-355)")
    return ["--model_kind", kind]


# Reference flag spellings that map onto a differently-named field here.
# Each entry: ref flag -> (target field, fn(value_or_None) -> replacement
# argv tokens, whether the flag takes a value).  Only applied when the
# target field exists on the config class, so one table serves the
# pretrain, finetune and predict configs.
_REF_FLAG_ALIASES = {
    # finetune / predict.  The reference declares --use_seq_cls_token with
    # `type=bool`, so any non-empty value parses True there (even "False");
    # here truthy strings and the bare flag select seq_cls, explicit falsy
    # strings keep the default
    "--use_seq_cls_token": ("model_kind", lambda v: (
        ["--model_kind", "seq_cls"]
        if v is None or v.lower() in _TRUTHY else []), True),
    "--decoder_type": ("model_kind", _map_decoder_type, True),
    "--use_cls": ("use_mean_pooling",  # store_false dest=use_mean_pooling
                  lambda v: ["--no_use_mean_pooling"], False),
    # pretrain (store_true)
    "--moco_m_cos": ("use_moco_m_cos",
                     lambda v: ["--use_moco_m_cos"], False),
}


def _translate_reference_flags(argv, cls):
    """Rewrite reference-CLI flag spellings into this config's flags (in
    place in the argv stream, so later explicit flags still win)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    out, translated, i = [], [], 0
    while i < len(argv):
        tok = argv[i]
        name, eq, inline = tok.partition("=")
        rule = _REF_FLAG_ALIASES.get(name)
        if rule is None:
            out.append(tok)
            i += 1
            continue
        target, fn, takes_value = rule
        val = inline if eq else None
        if takes_value and val is None and i + 1 < len(argv) \
                and not argv[i + 1].startswith("--"):
            val = argv[i + 1]
            i += 1
        i += 1
        if target not in fields:
            # not this config's flag: re-emit the flag and the value it
            # consumed, so the unknown-flags warning reports what was passed
            out.append(tok)
            if val is not None and not eq:
                out.append(val)
            continue
        repl = fn(val)
        out.extend(repl)
        translated.append(f"{name} -> {' '.join(repl) or '(default)'}")
    if translated:
        print(f"[config] reference flags translated: {translated}")
    return out


def parse_config(cls=PredictConfig, argv=None):
    """Parse CLI args into a config dataclass, as `dig_tpu.config.parse_config`
    does: unknown flags are accepted with a warning, and the reference
    CLIs' spellings are translated onto their fields here
    (`_REF_FLAG_ALIASES`)."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    argv = _translate_reference_flags(argv, cls)
    cfg = cls()
    parser = argparse.ArgumentParser(cls.__name__, allow_abbrev=False)
    _add_field_args(parser, cfg)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"[config] ignoring unknown flags: {unknown}")
    for f in dataclasses.fields(cfg):
        val = getattr(args, f.name)
        default = getattr(cfg, f.name)
        if isinstance(default, tuple) and isinstance(val, list):
            val = tuple(float(x) for x in val)
        if isinstance(default, int) and not isinstance(default, bool):
            val = int(val)
        setattr(cfg, f.name, val)
    return cfg


def config_to_json(cfg) -> str:
    """The config as JSON; an infinite value (`num_samples`) as the string
    "inf", which strict JSON can carry."""
    d = dataclasses.asdict(cfg)
    for k, v in d.items():
        if v == float("inf"):
            d[k] = "inf"
    return json.dumps(d, indent=2, default=str)


@dataclasses.dataclass
class PretrainConfig:
    """`dig_tpu.config.PretrainConfig`: the same fields and defaults, parsed
    by `dig_tpu_torch.cli.run_pretrain`; `n_fsdp` / `n_tensor` shard the
    parameters (`parallel/sharding.py`)."""

    # model
    model: str = "pretrain_simmim_moco_ori_vit_small_patch4_32x128"
    input_h: int = 32
    input_w: int = 128
    patch_size: int = 4
    drop_path: float = 0.0
    normlize_target: bool = True  # (sic -- reference flag spelling)
    # masking / views
    mask_ratio: float = 0.7
    num_view: int = 2
    # moco
    moco_dim: int = 256
    moco_mlp_dim: int = 4096
    moco_m: float = 0.99
    use_moco_m_cos: bool = True
    moco_t: float = 0.2
    num_windows: int = 4
    patchnet_name: str = "regular"
    label_smoothing: float = 0.0
    # loss weights
    loss_weight_pixel: float = 1.0
    loss_weight_contrast: float = 0.1
    contrast_warmup_steps: int = 500
    contrast_start_epoch: int = 0
    only_mim_on_ori_img: bool = True
    # optimization
    batch_size: int = 128  # per host
    epochs: int = 10
    opt: str = "adamw"
    opt_betas: Tuple[float, float] = (0.9, 0.999)
    opt_eps: float = 1e-8
    clip_grad: Optional[float] = None
    weight_decay: float = 0.1
    weight_decay_end: Optional[float] = None
    lr: float = 1.5e-4
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    warmup_epochs: int = 0
    warmup_steps: int = 5000
    # data
    image_alone_path: List[str] = dataclasses.field(default_factory=list)
    voc_type: str = "ALLCASES_SYMBOLS"
    max_len: int = 25
    aloneimage_num_samples: float = float("inf")
    num_workers: int = 10
    worker_type: str = "thread"
    batch_wise_shuffle: bool = False
    # run
    output_dir: str = "./output"
    log_dir: Optional[str] = None
    seed: int = 0
    resume: str = ""
    auto_resume: bool = True
    start_epoch: int = 0
    save_ckpt_freq: int = 1
    keep_ckpt_max: int = 0
    eval_freq: int = 1000
    profile_steps: int = 0
    profile_start_step: int = 10
    dtype: str = "bfloat16"
    # the JAX package's additions, kept for flag compatibility
    device_aug: bool = False
    remat: bool = False
    n_fsdp: int = 1
    n_tensor: int = 1

    @property
    def input_size(self):
        return (self.input_h, self.input_w)

    @property
    def window_size(self):
        return (self.input_h // self.patch_size, self.input_w // self.patch_size)

    def finalize(self, num_devices: int = 1):
        """Linear lr scaling: absolute_lr = lr * total batch / 256
        (run_mae_pretraining_moco.py:382); wd_end defaults to wd."""
        if self.num_view != 2:
            raise ValueError(f"--num_view must be 2 (got {self.num_view})")
        self.absolute_lr = self.lr * (self.batch_size * num_devices) / 256.0
        if self.weight_decay_end is None:
            self.weight_decay_end = self.weight_decay
        return self


@dataclasses.dataclass
class FinetuneConfig:
    """`dig_tpu.config.FinetuneConfig`: the same fields and defaults, read by
    `cli/run_finetune.py` for every model kind."""

    # model
    model: str = "vit_small_patch4_32x128"
    decoder_name: str = "tf_decoder"
    model_kind: str = "rec"  # rec | ctc | attn | seq_cls | mim_rec
    mim_sample_ratio: float = 0.5
    use_mim_proj: bool = False
    mask_ratio: float = 0.7
    loss_weight_pixel: float = 1.0
    normlize_target: bool = True  # (sic -- reference flag spelling)
    use_feat_distill: bool = False
    loss_weight_feat_distill: float = 1.0
    teacher_ckpt: str = ""
    nb_classes: int = 97
    max_len: int = 25
    drop: float = 0.1
    attn_drop_rate: float = 0.1
    drop_path: float = 0.1
    use_1d_attdec: bool = False
    use_mean_pooling: bool = True
    text_cond_vis: bool = False
    beam_width: int = 0
    # recipe
    batch_size: int = 256
    epochs: int = 10
    update_freq: int = 1
    opt: str = "adamw"
    opt_betas: Tuple[float, float] = (0.9, 0.999)
    opt_eps: float = 1e-8
    clip_grad: Optional[float] = None
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None
    lr: float = 1e-4
    layer_decay: float = 1.0
    warmup_lr: float = 1e-6
    min_lr: float = 1e-6
    warmup_epochs: int = 1
    warmup_steps: int = -1
    smoothing: float = 0.1
    fixed_encoder_layers: int = 0
    # init / resume
    finetune: str = ""
    model_key: str = "model|module"
    model_prefix: str = ""
    exact_gelu: Optional[bool] = None  # None = auto (erf for .pth weights)
    resume: str = ""
    auto_resume: bool = True
    start_epoch: int = 0
    # data
    data_path: List[str] = dataclasses.field(default_factory=list)
    eval_data_path: str = ""
    other_test_data_folders: List[str] = dataclasses.field(default_factory=list)
    voc_type: str = "ALLCASES_SYMBOLS"
    num_samples: float = float("inf")
    num_view: int = 2
    use_abi_aug: bool = True
    device_abi_aug: bool = False
    num_workers: int = 10
    worker_type: str = "thread"
    batch_wise_shuffle: bool = False
    # run
    output_dir: str = "./output"
    log_dir: Optional[str] = None
    seed: int = 0
    save_ckpt: bool = True
    save_best: bool = True
    save_ckpt_freq: int = 1
    keep_ckpt_max: int = 0
    eval_freq: int = 1000
    profile_steps: int = 0
    profile_start_step: int = 10
    eval: bool = False
    dist_eval: bool = False
    input_h: int = 32
    input_w: int = 128
    dtype: str = "bfloat16"
    n_fsdp: int = 1
    n_tensor: int = 1

    def finalize(self, num_devices: int = 1):
        """absolute_lr = lr * total batch / 256 (run_class_finetuning.py:464),
        the total counting `update_freq`; wd_end defaults to wd."""
        total_bs = self.batch_size * num_devices * self.update_freq
        self.absolute_lr = self.lr * total_bs / 256.0
        if self.weight_decay_end is None:
            self.weight_decay_end = self.weight_decay
        return self
