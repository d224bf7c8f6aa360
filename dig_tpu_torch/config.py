"""Configurations with the JAX package's flag names: batch inference
(`PredictConfig`), pre-training (`PretrainConfig`) and fine-tuning
(`FinetuneConfig`).

`PredictConfig` has the fields and defaults of `dig_tpu.config.PredictConfig`
so that a command line written for `dig_tpu.cli.run_predict` parses the
same here.  Options this slice does not run yet (`--data_path` LMDB input,
`--resume` of a native checkpoint, beam search, other model kinds) parse
and are refused by the CLI with a message.
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
    # weights: --resume = native dig_tpu checkpoint dir (refused here);
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


def parse_config(cls=PredictConfig, argv=None):
    """Parse CLI args into a config dataclass; unknown flags are accepted
    with a warning, as `dig_tpu.config.parse_config` does."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
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
        setattr(cfg, f.name, val)
    return cfg


def config_to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


@dataclasses.dataclass
class PretrainConfig:
    """`dig_tpu.config.PretrainConfig`: the same fields and defaults.  The
    pretrain CLI that parses them is not ported yet."""

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
    """`dig_tpu.config.FinetuneConfig`: the same fields and defaults.  The
    port runs its `rec` fine-tuning step (`train/finetune.py`); the
    fine-tuning CLI, the other model kinds and `update_freq` > 1 are not
    ported yet."""

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
