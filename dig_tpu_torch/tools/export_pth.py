"""Export a checkpoint to a reference-layout .pth, without JAX: the port's
counterpart of `tools/export_pth.py`.

Weights trained with the port (or with `dig_tpu`) load into the reference
ecosystem (run_class_finetuning.py --finetune, whose surgery reads
``{"model": state_dict}``; :362-441), and back into either package's
``--finetune``.

    python -m dig_tpu_torch.tools.export_pth out/checkpoint-best dig_export.pth
    python -m dig_tpu_torch.tools.export_pth pre/checkpoint-9 enc.pth --encoder_only [--ema]

`checkpoint` is a port checkpoint directory, a native `dig_tpu` one
(``arrays.npz`` + ``treedef.pkl``, read without JAX) or a remote URI
(`utils/checkpoint.py::restore_checkpoint`).  The keys and values are
those `dig_tpu`'s exporter writes for the same weights
(`utils/export_torch.py`).
"""

from __future__ import annotations

import argparse

import torch

from dig_tpu_torch.utils.checkpoint import restore_checkpoint
from dig_tpu_torch.utils.export_torch import NoEmaError, export_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="checkpoint directory (port or native dig_tpu) or URI")
    ap.add_argument("output_pth")
    ap.add_argument("--encoder_only", action="store_true",
                    help="export only the ViT encoder (e.g. a pre-training checkpoint's "
                         "student encoder)")
    ap.add_argument("--patch_size", type=int, default=4)
    ap.add_argument("--ema", action="store_true",
                    help="export the EMA / momentum branch's weights if present")
    args = ap.parse_args(argv)

    payload = restore_checkpoint(args.checkpoint)
    try:
        sd = export_checkpoint(payload, args.encoder_only, args.ema, args.patch_size)
    except NoEmaError:
        raise SystemExit(f"--ema: checkpoint {args.checkpoint} carries no EMA tree") from None
    torch.save({"model": sd}, args.output_pth)
    print(f"wrote {len(sd)} tensors -> {args.output_pth}")


if __name__ == "__main__":
    main()
