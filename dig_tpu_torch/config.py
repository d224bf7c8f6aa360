"""Batch-inference configuration with the JAX package's flag names.

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
from typing import List, Optional


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
        elif isinstance(default, list):
            parser.add_argument(name, nargs="*", default=default)
        elif isinstance(default, float):
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
        setattr(cfg, f.name, getattr(args, f.name))
    return cfg


def config_to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
