"""How much a frozen encoder's features tell of the characters: a linear probe.

    python tools/encoder_ctc_probe.py TRAIN_LMDB TEST_LMDB [--checkpoint DIR]
        [--model vit_tiny_patch4_32x128] [--epochs 30] [--seed 0] [--device cuda]

Builds the recognizer's encoder of `--model` with random weights from
`--seed`, or with the encoder of `--checkpoint` (a pre-training or
fine-tuning checkpoint directory, loaded as `run_finetune --finetune` loads
it), and runs it frozen over every image of both LMDBs.  Each image's
token map is layer-normalised and averaged over the grid's height, which
leaves one feature vector per column; a linear layer over those columns is
trained with CTC on TRAIN_LMDB's labels (Adam, lr 3e-3, batch 128,
`--epochs` passes).  Prints one JSON line: the mean CTC loss on both sets
after training, and the test set's word accuracy under greedy CTC decoding.

The probe asks of a pre-training run what its fine-tuning arm can only show
after many epochs: whether the encoder's columns already hold the
characters.  Random weights are its floor.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dig_tpu_torch import config  # noqa: E402
from dig_tpu_torch.cli.run_finetune import load_finetune_init  # noqa: E402
from dig_tpu_torch.data.dataset import build_dataset  # noqa: E402
from dig_tpu_torch.models.rec_model import build_rec_model  # noqa: E402
from dig_tpu_torch.ops.images import to_model_images  # noqa: E402
from dig_tpu_torch.utils.charset import build_charset  # noqa: E402

VOC, MAX_LEN, BATCH = "ALLCASES_SYMBOLS", 25, 128


def load_split(path):
    """(uint8 images [N, 32, 128, 3], label ids without EOS, one list a row)."""
    ds = build_dataset(path, is_train=False, voc_type=VOC, max_len=MAX_LEN)
    eos = build_charset(VOC, MAX_LEN).eos_id
    items = [ds[i] for i in range(len(ds))]
    labels = [[int(c) for c in lab[:n] if c != eos] for _, lab, n in items]
    return np.stack([im for im, _, _ in items]), labels


@torch.no_grad()
def column_features(encoder, images, device):
    """[N, columns, C]: the frozen encoder's token map, layer-normalised
    (no scale or shift), averaged over the grid's height."""
    out = []
    gh, gw = encoder.patch_shape
    for i in range(0, len(images), BATCH):
        x = to_model_images(torch.as_tensor(images[i:i + BATCH]).to(device))
        e = encoder(x).float()
        b, _, c = e.shape
        out.append(F.layer_norm(e, (c,)).reshape(b, gh, gw, c).mean(1).cpu())
    return torch.cat(out)


def ctc_loss(head, feats, labels, blank):
    lp = head(feats).log_softmax(-1).transpose(0, 1)  # [T, N, classes]
    targets = torch.tensor([c for lab in labels for c in lab], dtype=torch.long)
    lens = torch.tensor([len(lab) for lab in labels], dtype=torch.long)
    frames = torch.full((feats.shape[0],), feats.shape[1], dtype=torch.long)
    return F.ctc_loss(lp, targets, frames, lens, blank=blank, zero_infinity=True)


def greedy(ids, blank):
    return [int(a) for k, a in enumerate(ids) if a != blank and (k == 0 or a != ids[k - 1])]


def probe(train_lmdb, test_lmdb, checkpoint="", model="vit_tiny_patch4_32x128", epochs=30,
          seed=0, device="cuda") -> dict:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("encoder_ctc_probe runs on CUDA and no card is visible; "
                           "pass --device cpu for the CPU")
    rec = build_rec_model(model, "small_tf_decoder", device="cpu", seed=seed)
    if checkpoint:
        cfg = config.parse_config(config.FinetuneConfig, ["--model", model, "--finetune",
                                                          checkpoint])
        load_finetune_init(cfg, rec)
    encoder = rec.encoder.to(device).eval()
    (tr_img, tr_lab), (te_img, te_lab) = load_split(train_lmdb), load_split(test_lmdb)
    tr, te = column_features(encoder, tr_img, device), column_features(encoder, te_img, device)
    blank = build_charset(VOC, MAX_LEN).num_classes
    gen = torch.Generator().manual_seed(seed)
    head = torch.nn.Linear(tr.shape[-1], blank + 1)
    with torch.no_grad():
        head.weight.normal_(0.0, 0.02, generator=gen)
        head.bias.zero_()
    opt = torch.optim.Adam(head.parameters(), 3e-3)
    for _ in range(epochs):
        perm = torch.randperm(len(tr), generator=gen).tolist()
        for i in range(0, len(perm), BATCH):
            rows = perm[i:i + BATCH]
            loss = ctc_loss(head, tr[rows], [tr_lab[r] for r in rows], blank)
            opt.zero_grad()
            loss.backward()
            opt.step()
    with torch.no_grad():
        ids = head(te).argmax(-1).numpy()
        correct = sum(greedy(p, blank) == t for p, t in zip(ids, te_lab))
        return {"checkpoint": checkpoint or None, "model": model, "epochs": epochs,
                "n_train": len(tr_lab), "n_test": len(te_lab),
                "train_ctc_loss": float(ctc_loss(head, tr, tr_lab, blank)),
                "test_ctc_loss": float(ctc_loss(head, te, te_lab, blank)),
                "test_word_acc": correct / max(len(te_lab), 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("train_lmdb")
    ap.add_argument("test_lmdb")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--model", default="vit_tiny_patch4_32x128")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    result = probe(a.train_lmdb, a.test_lmdb, a.checkpoint, a.model, a.epochs, a.seed, a.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
