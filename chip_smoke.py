#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`dig_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds every CUDA kernel of
   the port from `dig_tpu_torch/ops/csrc/` (one nvcc per source, all
   started together) and prints each build's ptxas summary: the bf16
   attention bodies' registers, shared memory, spills, and whether ptxas
   serialised their wgmma products.  `[logits probe]` holds the logits of
   every operand form the backward takes equal to the forward's wgmma
   logits of the same bf16 q and k bit for bit (`csrc/attention_probe.cu`).
2. Holds each kernel against its plain PyTorch version, in bf16 and fp32
   (the attention kernels' bf16 bodies, forward and backward, run on the
   tensor cores, their fp32 bodies on the FMA pipes; the recompute backward
   must equal the stored-statistics backward bit for bit in both dtypes):
   the stored-statistics attention forward and the
   LayerNorm forward at the predict path's shapes (B=512, 256 tokens,
   width 384, 6 heads x 64);
   the backward kernels, the recompute attention pair (both branches of
   its forward) and the column sum at the pre-training step's shapes
   (B=256 sequences: 2 views x 128 images; LayerNorm rows 65,536 x 384, and
   1,000 x 384 and 512 x 1024 for the backward, whose two calls on the same
   inputs must give the same bits; the fc1 bias gradient 65,536 x 1536, and
   a ragged row count); and times the
   kernel, the plain version and one PyTorch library call for the same
   function (a yardstick the port never calls), with the share of the
   bound each kernel reaches.  Every backward check's second call writes
   into NaN-filled gradients.  `[attention_bwd stress]` launches the bf16
   #4 and #2 2,000 times each at three of the path's shapes (NaN-filled
   gradients and scratch, half beside a second stream's GEMMs) and fails
   on any launch whose bits differ from the first's; the kernels line
   carries the counts.
3. Runs the predict path at full width (vit_small_patch4_32x128 +
   tf_decoder, bf16, batch 512, random weights from a seed) on synthetic
   uint8 batches through the entry points a user calls, and asserts from
   the wrappers' launch counts that every batch went through both forward
   kernels (12 attention and 24 LayerNorm launches per batch).  Then the
   predict CLI itself (`run_predict.main`, a reference flag spelling in its
   argv) on 3 PNG files and an LMDB of 1,024 PNG records and a corrupt one,
   with the same counts asserted per batch and every TSV line checked, and
   the host's numpy bicubic against the installed OpenCV's.
4. Checks the card's predict path against the port's CPU path on 8 images
   in fp32.
5. Runs the pre-training step (`make_pretrain_step`) at full width
   (pretrain_simmim_moco_ori_vit_small_patch4_32x128, bf16, batch 128,
   random weights from a seed, the CLI's default schedules): 3 warm-up
   steps, then 10 (timed by item 15's `[bench_torch pretrain]`, not here);
   asserts the launches per step of every kernel (24 / 12
   stored-statistics attention forward / backward, 48 / 24 LayerNorm
   forward / backward), a finite loss, a finite gradient on every student
   parameter, and that the parameters and the momentum branch moved.  Then
   the same under the JAX package's opt-in switches
   DIG_TPU_ATTN_STORE_LSE=0 and DIG_TPU_FUSED_BIAS_GRAD=1, with
   DIG_TPU_ATTN_BF16_EXP off and on: 24 / 12 recompute attention forward /
   backward and 14 column sums a step instead, the switches' steps timed
   and profiled (with the bf16 exponent: checked only).
6. Checks one fp32 pre-training step of the full-width model at batch 2
   on the card against the same step on the CPU, as is and under the
   switches.
7. Runs the fine-tuning step (`make_finetune_step`) at the FinetuneConfig
   defaults (vit_small_patch4_32x128 + tf_decoder, bf16, batch 256,
   dropout, attention dropout and drop-path on, label smoothing 0.1, AdamW
   with the CLI's schedules), with DIG_TPU_FUSED_BIAS_GRAD off and on, and
   the eval step (`make_eval_step`, greedy, full length) on one batch of
   256 with each attention pair; asserts their launch counts.
8. Checks one fp32 fine-tuning step of the full-width recognizer (rates 0,
   the column sum on) on the card against the CPU.  Then every recognizer
   kind: `[attention at L=281]` holds #3, #4, #1 and #2 against their plain
   versions at the seq-cls encoder's shape (B=256, L=281, H=12, D=64; bf16
   and fp32), each timed beside SDPA; `[kinds step]` runs each kind's step
   at the FinetuneConfig defaults, full width, bf16, batch 256 (halved until
   it fits where it does not: the text-conditional decoder), 2 warm-up and
   5 timed steps (ctc, attn, mim_rec and the decoupled decoder on
   vit_small; rec with --text_cond_vis; distillation from a second
   recognizer of the same seed; seq_cls on vit_seq_cls_base as is and with
   attention dropout 0), asserting its launches a step, a finite loss, a
   finite gradient on every trainable tensor, that they moved and that the
   teacher did not, then its eval batch (greedy at full length; beam 3 for
   attn and the decoupled decoder) with its launches; `[memory bank]` one
   step of a recognizer whose encoder holds a frozen memory bank (no
   gradient, bit-equal after the step); `[kinds cpu parity]`
   one fp32 step and one greedy eval batch of each kind at batch 2, rates
   0, card against CPU (every gradient leaf, the ids equal).
9. Drives the pre-training data path and CLI at full width on an LMDB of
   512 seeded PNG word images (4 steps an epoch at batch 128): the
   on-device view generator on one batch (exact mask counts, range, and in
   fp32 the card against the CPU under one set of draws); the loader alone
   over one epoch, with host SeqCLR augmentation and without (thread
   workers), and on 8 process workers started from this process with CUDA
   initialised, one iterator abandoned half-way first (a watchdog fails the
   run if it hangs); `run_pretrain.main` itself for
   two epochs with host augmentation and with `--device_aug` (8 steps, the
   launch counts of item 5 at every step, finite losses in log.txt, both
   checkpoints, parameters moved); and resume equivalence in fp32: two
   epochs straight against one epoch, a fresh `main` that auto-resumes, and
   the second epoch, every parameter, momentum parameter and AdamW moment
   compared bit for bit.
10. Drives the fine-tuning CLI at the FinetuneConfig defaults on labelled
   LMDBs (512 train records, 2 steps an epoch; 256 eval records), its
   encoder from item 9's last pre-training checkpoint directory (checked bit
   for bit): `run_finetune.main` with host ABI augmentation and with
   `--device_abi_aug` (2 epochs, eval after each; 24 / 24 LayerNorm launches
   at every step, 12 / 24 attention / LayerNorm launches every eval batch);
   `device_abi_augment` alone on one batch (card vs CPU under one set of
   draws, and its time); resume equivalence in fp32 with attention dropout
   0 and `--update_freq 2` (12 / 12 / 24 / 24 launches a micro-step; every
   parameter, AdamW moment, step tensor and accumulator bit for bit,
   log.txt byte for byte); the `--eval` sweep over two LMDBs, greedy and
   beam 3 (eval_results.json), beam width 1 against greedy, a beam batch
   timed; `[kinds cli]`: `run_finetune.main` with `--decoder_type
   attention`, with `--use_seq_cls_token --model
   vit_seq_cls_base_patch4_32x128` and with `--use_feat_distill
   --teacher_ckpt` the fine-tuning CLI's checkpoint directory (1 epoch of 2
   steps + eval, launches of every step and eval batch asserted), and
   `run_predict.main` with `--model_kind ctc` and with `--decoder_name
   decoupled_tf_decoder` on the 512-record LMDB (every TSV line checked).
   `to_model_images` on the card against the CPU for all 256
   values, and `torch.cuda.set_sync_debug_mode("warn")` over one
   fine-tuning step and one beam batch.
11. Runs both training CLIs data-parallel under torchrun
   (`python -m torch.distributed.run --nproc_per_node 1`, this script's
   `--ddp-child` mode calling `run_pretrain.main` / `run_finetune.main`):
   the process group must be NCCL at world size 1 and be torn down at the
   end.  `[ddp pretrain cli]`: PretrainConfig defaults with `--device_aug`
   on item 9's LMDB, 2 epochs, the launches of item 5 at every step, ms a
   step beside the one-process run's; then item 9's fp32 resume argv,
   whose parameters, AdamW state and log.txt must equal the one-process
   straight run's bit for bit.  `[ddp finetune cli]`: item 10's argv with
   `--dist_eval`, the launches of every step and eval batch, ms a step
   beside the one-process run's; then item 10's fp32 resume argv
   (`--update_freq 2`), equal bit for bit to its straight run.
12. The training options the port once refused, and the steps'
   reproducibility.  `[determinism]`: each fine-tuning kind (rec, ctc,
   attn, mim_rec, decoupled, seq_cls, distill) at the FinetuneConfig
   defaults, two steps from one state and one batch of repeated ids, every
   gradient and parameter `torch.equal`, then one step under
   `torch.use_deterministic_algorithms(True, warn_only=True)` to name the
   ops without a reproducible CUDA path.  `[pretrain remat]`: the
   pre-training step with `remat` (36 / 12 / 72 / 24 launches, derived in
   `REMAT_PER_STEP`), ms and peak memory with it off and on, and one fp32
   step with drop-path 0.1 and one generator equal bit for bit to the
   plain step (bf16 reported).  `[pretrain conv patchnet]`: the step with
   `patchnet_name conv` (the encoder's launches), and fp32 card against
   CPU at depth 2.  `[optimizers]`: every `--opt` name fp32 card against
   CPU (7 updates: clipping, layer decay, a frozen block, no-decay
   parameters; LAMB also at `update_freq` 2), then 3 bf16 pre-training
   steps each at full width (AdaHessian raises, as in `dig_tpu`).  In
   item 9's directory, `[pretrain cli options]`: `run_pretrain.main` with
   `--remat --patchnet_name conv --opt lamb --drop_path 0.1`, 2 epochs, and
   its fp32 `--device_aug` resume bit for bit (LAMB's state included); in
   item 10's, a CTC fp32 resume (`[finetune cli resume --model_kind ctc]`)
   and `[finetune cli opt]`: `run_finetune.main --opt adamp`, 1 epoch + eval.
13. `[two ranks one card]`, a separate check: two ranks on the one card
   over gloo (NCCL refuses two ranks on one device; the port's own card
   path stays NCCL), each running the full-width fp32 pre-training and
   fine-tuning steps on its half of a global batch of 8 through the
   kernels, against one process on the whole batch.
14. Parameter sharding (`--n_fsdp`, `--n_tensor`), over gloo on the one
   card (`--sharded-child` mode under torchrun; not a scaling figure).
   `[attention at the tensor split]`: #1-#4 on one tensor rank's 3 heads
   (the packed [256, 256, 576] layout) against their plain versions,
   timed beside SDPA.  `[sharded pretrain one card]` (meshes 1x2x1, 1x1x2,
   1x2x2) and `[sharded finetune one card]` (1x2x1, 1x1x2): the full-width
   steps, bf16, 1 step at the global batch (128; 256), the parameters,
   momentum branch and AdamW state sharded by the rules: each rank's
   launches a step, the grad norm equal on every rank and the loss on
   tensor peers, tensor peers' replicated parameters bit-equal, each
   rank's parameter + AdamW bytes equal to the rules' share, peak memory
   and ms a step; one fp32 step at a global batch of 8 (the pre-training
   encoder at depth 4) against one process within item 13's bounds.  In
   item 10's directory, `[sharded cli]`: `run_pretrain.main --n_fsdp 2`
   for 2 epochs, its last checkpoint resumed by one process bit for bit;
   `run_finetune.main --n_tensor 2` from item 9's checkpoint, 1 epoch +
   eval, its eval line equal to one process's `--eval` of its checkpoint.
15. `[export pth]` (in item 10's directory): `dig_tpu_torch.tools.export_pth`
   on item 9's last pre-training checkpoint (`--encoder_only`, and with
   `--ema`) and item 10's fine-tuning checkpoint, every tensor equal to the
   checkpoint's; each .pth fed back through `run_finetune --eval --finetune`
   (and the recognizer's through `run_predict --finetune`), its ids equal
   to its source's.  `[bench_torch]`: `python bench_torch.py` as a child in
   each of its four modes at its defaults: bench.py's keys and the card's
   name and power limit, value > 0, 0 < mfu <= 1 (pretrain, finetune), each
   part of the breakdown > 0 and the step's busy time within its wall
   time (the step time and idle share of item 5's step), and the launches a step
   each child reports (pretrain and input's bare step 24 / 12 / 48 / 24,
   finetune at attention dropout 0 12 / 12 / 24 / 24, an eval batch 12 / 24).
16. `[validation study]`: `python -m dig_tpu_torch.tools.validation_study`
   as a user runs it, at a small scale of its protocol (ViT-tiny, 1,024
   unlabeled, 1 pre-training epoch, 256 labeled, 128 test, 2 fine-tuning
   epochs: corpora, pretrain, ft_scratch, ft_ssl), started after item 14's
   `[attention at the tensor split]` timings and running beside `[two ranks
   one card]` and `[sharded ...]` (gloo correctness checks; the card's
   timed phases run alone): every stage on the card,
   each training stage's launches equal to its steps' and eval batches'
   (24 / 12 attention forward / backward a pre-training step, none a
   fine-tuning step at attention dropout 0.1, 12 forwards an eval batch:
   ViT-tiny's width, 192, takes no LayerNorm kernel), the SSL arm initialised
   from the pre-training checkpoint, each arm's word accuracy in [0, 1];
   each stage's wall seconds beside the card's name and power limit.  Its
   corpora are carried in as a user carries a render from another machine:
   the runner renders them into a directory of their own, `pack` of
   `tools/study_corpora.py` writes them into an xz archive and `unpack`
   puts them into the runner's workdir (the archive's mode opens on this
   machine); the runner then makes no corpus, and results.json names the
   manifest's sha256 beside this machine's OpenCV build.
17. Prints the seconds each phase took (`[phase seconds]`, a phase's
   own phases counted in it too), one JSON line describing every kernel,
   then as the last line {"ok": true, "device": {...}}.

Exits non-zero, without the result lines, when no CUDA device is visible,
when the package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

B, L, H, D = 512, 256, 6, 64
C = H * D
N_BATCHES = 4
CLI_RECORDS, CLI_FILES = 1024, 3  # what the predict CLI phase reads: an LMDB and image files
PRE_BATCH = 128            # images per pre-training step; 2 views -> 256 sequences
PRE_B = 2 * PRE_BATCH
PRE_WARMUP, PRE_STEPS = 3, 10
PRE_MASKED = 179           # exact-count SimMIM masks: 179 of 256 patches per view
PRE_CLI_RECORDS, PRE_CLI_EPOCHS = 512, 2  # the pre-training CLI's LMDB: 4 steps an epoch
PRE_CLI_STEPS = PRE_CLI_RECORDS // PRE_BATCH * PRE_CLI_EPOCHS
# the view generator, card vs CPU under the same draws, fp32 images in [-1, 1].
# With the matrices given, the warp's source coordinates are equal to the bit
# on both (they are summed in one fixed order), and the views agree within
# WARP_ATOL.  From the draws, the two devices' cos, sin and tan differ by an
# ulp or two: up to 2e-5 pixels at the image's ends, and up to 4e-5 in a
# bilinear sample of these records, which are noise (neighbours up to 2 apart)
WARP_ATOL, VIEW_ATOL = 1e-5, 1e-4
DDP_CHILD_TIMEOUT = 600  # seconds a torchrun call may take, its start included
TWO_RANK_BATCH = 8  # the global batch of [two ranks one card]: 2 ranks x 4
KERNEL_NAMES = ("attention_lse_fwd", "attention_lse_bwd", "attention_fwd", "attention_bwd",
                "layer_norm_fwd", "layer_norm_bwd", "column_sum")


def per_step(**counts):
    """Launches per step of every kernel wrapper, 0 where not named."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


PER_STEP = per_step(attention_lse_fwd=24, attention_lse_bwd=12, layer_norm_fwd=48,
                    layer_norm_bwd=24)
# under DIG_TPU_ATTN_STORE_LSE=0 and DIG_TPU_FUSED_BIAS_GRAD=1: the recompute
# pair replaces the stored-statistics one; the column sum serves every Mlp
# fc1 with at least 2 x 512 rows: the 12 encoder blocks (256 x 256 rows) and
# the window extractor's 2 CrossBlocks (256 sequences x 4 windows = 1,024
# rows, right at the gate); the momentum branch runs no backward
PER_STEP_SWITCHES = per_step(attention_fwd=24, attention_bwd=12, layer_norm_fwd=48,
                             layer_norm_bwd=24, column_sum=14)
# at batch 2 the window extractor's Mlps see 4 x 4 = 16 rows: under the gate
PER_STEP_SWITCHES_B2 = dict(PER_STEP_SWITCHES, column_sum=12)
# fine-tuning at FinetuneConfig defaults: attention dropout sends every
# training-pass attention to the unfused path (no attention kernel); 24
# FusedLayerNorms; under the switch the 12 encoder fc1s take the column sum
# (the decoder's FFN is not an Mlp)
FT_PER_STEP = per_step(layer_norm_fwd=24, layer_norm_bwd=24)
FT_PER_STEP_SWITCH = dict(FT_PER_STEP, column_sum=12)
# rates 0 (the card-vs-CPU check): the encoder's attention takes the stored-statistics pair
FT_PER_STEP_RATES0 = dict(FT_PER_STEP_SWITCH, attention_lse_fwd=12, attention_lse_bwd=12)
SOURCES = ["attention_lse_fwd", "attention_lse_bwd", "attention_fwd", "attention_bwd",
           "layernorm_fwd", "layernorm_bwd", "colsum", "attention_probe"]
FT_BATCH = 256
FT_WARMUP, FT_STEPS = 3, 10
# the fine-tuning CLI's LMDBs: 2 steps an epoch, 1 eval batch (the second
# eval set ends in a partial batch)
FT_CLI_RECORDS, FT_CLI_EVAL_RECORDS, FT_CLI_EVAL2_RECORDS, FT_CLI_EPOCHS = 512, 256, 300, 2
FT_EVAL_BATCH = per_step(attention_lse_fwd=12, layer_norm_fwd=24)  # greedy or beam alike
# attention dropout 0 (the resume run): the encoder's attention on the kernel pair
FT_PER_STEP_RESUME = dict(FT_PER_STEP, attention_lse_fwd=12, attention_lse_bwd=12)
PROCESS_WATCHDOG_S = 60
# [validation study]: the runner's knobs (ViT-tiny, its default models) and
# what follows from them: 1 eval batch of 128 an epoch
STUDY_PRE_EPOCHS, STUDY_FT_EPOCHS, STUDY_TEST = 1, 2, 128
STUDY_KNOBS = ["--unlabeled", "1024", "--pre_epochs", str(STUDY_PRE_EPOCHS), "--labeled", "256",
               "--test", str(STUDY_TEST), "--ft_epochs", str(STUDY_FT_EPOCHS)]
STUDY_EVAL_BATCHES = -(-STUDY_TEST // 128)
# ViT-tiny's width, 192, is no multiple of 128: its LayerNorms take the
# plain version under the gate both packages share (`_use_pallas_ln`), so
# its steps run the attention kernels alone, and its fine-tuning step
# (attention dropout 0.1: the unfused attention) no kernel at all
STUDY_PRE_STEP = per_step(attention_lse_fwd=24, attention_lse_bwd=12)
STUDY_FT_STEP = per_step()
STUDY_EVAL_BATCH = per_step(attention_lse_fwd=12)
STUDY_TIMEOUT = 600
FC1_ROWS, FC1_COLS = PRE_B * 256, 4 * 384  # dy of fc1 in both trainers
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 FMA pipes
# tolerances, kernel vs plain version on identical inputs: both sum the
# same exact products in fp32 in another order, so fp32 results agree to a
# few ulp; a bf16 output may round to the neighbouring bf16 value (one ulp,
# at most 2^-7 of the value)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=1e-4)}
STAT_TOL = dict(rtol=1e-4, atol=1e-4)  # m and s, fp32 in both dtypes
# the bf16-exponential branch's o: the plain version's logits sum in
# another order, so the bf16 rounding of an exponent input may go the other
# way: one bf16 ulp of o (rtol 2^-7) plus 2^-8 absolute for the shift one
# flipped exponential gives its row
BF16_EXP_TOL = dict(rtol=2**-7, atol=2**-8)
# the bf16 tensor-core forward's o (kStats, kPlain) is held at TOL, except
# that at most this share of its elements may lie outside TOL, each within
# BF16_EXP_TOL: its logits are tensor-core sums in another order than the
# plain version's, which flips the bf16 rounding of the odd exponential
# (the card showed 7.3e-6 and 8.1e-6 of o at B=512 and 256; PERF.md)
FLIP_SHARE = 1e-4
# the bf16 attention kernels' times before their tensor-core bodies (the FMA
# bodies, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), printed beside the new ones
FMA_BODY_MS = {"attention_lse_fwd": 2.8060, "attention_fwd": 1.5702,
               "attention_fwd_bf16_exp": 1.5991, "attention_lse_bwd": 5.4234,
               "attention_bwd": 5.5640}
# the bf16 attention forward's times on its earlier tensor-core body
# (mma.sync, cp.async, two sweeps over K; NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md), printed beside the TMA / wgmma body's
MMA_SYNC_BODY_MS = {"attention_lse_fwd": 0.3407, "attention_fwd": 0.1769}
# the bf16 attention backward's times on its earlier tensor-core body
# (mma.sync, cp.async, a dq pass sweeping the keys twice; NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md), printed beside the TMA / wgmma body's
MMA_SYNC_BWD_BODY_MS = {"attention_lse_bwd": 0.5703, "attention_bwd": 0.6347}
# the LayerNorm backward's bf16 time before its redesign: one launch of 512
# blocks and two torch sums over its partial rows (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md), printed beside the new one
LN_BWD_FIRST_BODY_MS = 0.0944
# shapes beside the pre-training one: rows that are no multiple of a block's
# 8, fewer rows than the persistent grid has warps, the widest row
LN_BWD_EDGE_SHAPES = ((1000, 384), (512, 1024))
DESIGN = {"attention_lse_fwd": "TMA + wgmma bf16, warp-specialised and persistent, one sweep over "
                               "K up to 4 key tiles resident / FMA fp32",
          "attention_fwd": "TMA + wgmma bf16, warp-specialised and persistent, one sweep over K up "
                           "to 4 key tiles resident / FMA fp32",
          "attention_lse_bwd": "TMA + wgmma bf16, warp-specialised and persistent: a row pass (dq, "
                               "4 key tiles of logits resident) and a column pass (dk, dv, keys "
                               "as rows) / FMA fp32",
          "attention_bwd": "TMA + wgmma bf16, warp-specialised and persistent: a row pass (dq, m, "
                           "s, 4 key tiles of logits resident) and a column pass (dk, dv, keys as "
                           "rows) / FMA fp32",
          "layer_norm_fwd": "warp per row, two-pass variance",
          "layer_norm_bwd": "persistent grid, next row's loads ahead of the reductions, "
                            "partial dgamma / dbeta rows summed by a finishing kernel",
          "column_sum": "512-row chunk partials, then their sum"}
# column sums of 65,536 values: fp32 sums in another order (512-row chunks,
# then their partials; the plain version and the library their own trees),
# within 1e-5 of the largest sum
COLSUM_RTOL = 1e-5
# backward kernels vs plain versions, relative to each gradient's max |value|:
# in fp32 the same products in another order; in bf16 an intermediate the
# TPU kernel rounds to bf16 (e, ds0, the scaled q and do) may round the other
# way after an fp32 ulp of difference (the bf16 body's logits and dw are
# tensor-core sums), moving a sum of many terms by a fraction of one term
BWD_RTOL = {"float32": 1e-5, "bfloat16": 2**-6}
FEAT_RTOL = 1e-4  # encoder features, card vs CPU, relative to their max |value|
# one fp32 pre-training step, card vs CPU, relative to each gradient leaf's
# max |g|: 12 blocks of fp32 sums in another order (cuBLAS vs the CPU's
# BLAS, the kernels vs the plain versions), amplified by batch statistics
# over 16 rows and the InfoNCE softmax at T = 0.2; plus a floor of 1e-6 of
# the largest gradient for leaves that are zero by construction
STEP_RTOL, STEP_FLOOR = 1e-4, 1e-6
MARGIN_TOL = 1e-3  # greedy ids must agree where the CPU top-1 margin exceeds this


class SmokeFailure(RuntimeError):
    pass


PHASE_SECONDS = {}


def time_phases():
    """Wrap every `phase_*` function of this script so that the seconds
    each call takes add up in PHASE_SECONDS under its name."""
    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
        return run

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = timed(name[len("phase_"):], fn)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fma_body_text(name, key):
    """The bf16 FMA body's time (and the mma.sync body's) beside the new
    one, as text."""
    old = FMA_BODY_MS.get(name + key[len("bfloat16"):]) if key.startswith("bfloat16") else None
    text = f"; the FMA body took {old:.4f} ms (PERF.md)" if old else ""
    mma = {**MMA_SYNC_BODY_MS, **MMA_SYNC_BWD_BODY_MS}.get(name) if key == "bfloat16" else None
    return text + (f", the mma.sync body {mma:.4f} ms (PERF.md)" if mma else "")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def count_beyond(got, ref, tol):
    """How many elements of got lie outside tol of ref (assert_close's rule)."""
    diff = (got.float() - ref.float()).abs()
    return int((diff > tol["atol"] + tol["rtol"] * ref.float().abs()).sum())


def check_close(name, got, ref, tol):
    import torch

    err = max_err(got, ref)
    check(torch.allclose(got.float(), ref.float(), **tol), f"{name}: max abs err {err} beyond {tol}")
    return err


def check_fwd_o(name, got, ref, dn, bf16_exp=False):
    """An attention forward's o against its plain version: (max abs err,
    text).  fp32 within TOL, the bf16-exponential branch within
    BF16_EXP_TOL; the bf16 tensor-core body within TOL but for at most
    FLIP_SHARE of its elements, each within BF16_EXP_TOL."""
    if dn == "float32" or bf16_exp:
        return check_close(name, got, ref, BF16_EXP_TOL if bf16_exp else TOL[dn]), ""
    err = check_close(name, got, ref, BF16_EXP_TOL)
    n, allowed = count_beyond(got, ref, TOL[dn]), math.ceil(FLIP_SHARE * got.numel())
    check(n <= allowed, f"{name}: {n} of {got.numel()} elements outside {TOL[dn]}, "
          f"more than {allowed}")
    return err, f" ({n} of {got.numel()} outside TOL, at most {allowed} allowed)"


def phase_attention(torch, attn, gen):
    rows = {}
    scale = D**-0.5
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        qkv = torch.randn(B, L, 3 * C, generator=gen, device="cuda").to(dt)
        # head-split views of the packed projection's column slices, as the ViT passes them
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(B, L, H, D) for i in range(3))
        o, m, s = attn.attention_lse_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ro, rm, rs = attn.attention_lse_fwd_ref(q, k, v, scale)
        err, flips = check_fwd_o(f"attention {dn} o", o, ro, dn)
        check_close(f"attention {dn} m", m, rm, STAT_TOL)
        check_close(f"attention {dn} s", s, rs, STAT_TOL)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(lambda: attn.attention_lse_fwd(q, k, v, scale))
        plain_ms = time_ms(lambda: attn.attention_lse_fwd_ref(q, k, v, scale), iters=3)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
        isz = qkv.element_size()
        nbytes = 4 * B * L * C * isz + 2 * B * L * H * 4
        bms, by = bound(nbytes, 4 * B * H * L * L * D, dn)
        rows[dn] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, library_ms=lib_ms)
        print(f"[attention_lse_fwd {dn}] max_abs_err o={err:.3e}{flips} "
              f"m,s ok; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{bms / ms:.3f} of the bound{fma_body_text('attention_lse_fwd', dn)}")
        del qkv, q, k, v, o, m, s, ro, rm, rs
    return rows


def phase_layernorm(torch, ln, gen):
    rows = {}
    eps = 1e-6
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        x = torch.randn(B, L, C, generator=gen, device="cuda").to(dt)
        g = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        b = 0.1 * torch.randn(C, generator=gen, device="cuda")
        y = ln.layer_norm_fwd(x, g, b, eps)
        torch.cuda.synchronize()
        err = check_close(f"layernorm {dn}", y, ln._ln_ref(x, g, b, eps), TOL[dn])
        gd, bd = g.to(dt), b.to(dt)
        ms = time_ms(lambda: ln.layer_norm_fwd(x, g, b, eps), iters=50)
        plain_ms = time_ms(lambda: ln._ln_ref(x, g, b, eps), iters=10)
        lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(x, (C,), gd, bd, eps), iters=50)
        nbytes = 2 * B * L * C * x.element_size() + 2 * C * 4
        bms, by = bound(nbytes, 8 * B * L * C, "float32")
        rows[dn] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, library_ms=lib_ms)
        print(f"[layer_norm_fwd {dn}] max_abs_err={err:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


def phase_predict(torch, np):
    from dig_tpu_torch.cli.run_predict import make_predict_fn, predict_batches
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.utils.charset import build_charset
    from dig_tpu_torch.utils.profiling import profile_fn

    charset = build_charset("ALLCASES_SYMBOLS", 25)
    model = build_rec_model("vit_small_patch4_32x128", "tf_decoder", charset.num_classes, 25,
                            dtype=torch.bfloat16, seed=0, device="cuda")
    predict_fn = make_predict_fn(model, charset.eos_id)
    rng = np.random.default_rng(0)
    batches = [([f"synthetic-{i}-{j}" for j in range(B)],
                rng.integers(0, 256, (B, 32, 128, 3), dtype=np.uint8))
               for i in range(N_BATCHES + 1)]
    # warm-up batch: first cuBLAS handles, allocator growth
    list(predict_batches(predict_fn, batches[:1], B, "cuda"))
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    results = list(predict_batches(predict_fn, batches[1:], B, "cuda"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = per_step(attention_lse_fwd=12 * N_BATCHES, layer_norm_fwd=24 * N_BATCHES)
    check(counts == want, f"predict launches {counts} != {want}")
    n_attn, n_ln = counts["attention_lse_fwd"], counts["layer_norm_fwd"]
    for names, ids, conf in results:
        check(ids.shape == (B, 25) and conf.shape == (B,), f"shapes {ids.shape} {conf.shape}")
        check(np.isfinite(conf).all() and (conf > 0).all() and (conf <= 1 + 1e-6).all(),
              "confidences not in (0, 1]")
        check(((ids >= 0) & (ids < charset.num_classes)).all(), "ids out of range")
    ips = N_BATCHES * B / dt

    # where the time goes, one batch: encoder + bridge vs the 25-step decoder
    from dig_tpu_torch.ops.images import to_model_images

    x_u8 = torch.from_numpy(batches[0][1]).cuda()
    x = to_model_images(x_u8)
    with torch.no_grad():
        enc_ms = time_ms(lambda: model.linear_norm(model.encoder(x)), iters=3, warmup=1)
        feats = model.linear_norm(model.encoder(x))
        dec_ms = time_ms(lambda: model.decoder.greedy_decode(feats), iters=3, warmup=1)
    top, busy_ms, wall_ms = profile_fn(lambda: predict_fn(x_u8))
    for name, ms in top:
        print(f"[profile] {ms:9.3f} ms  {name[:100]}")
    print(f"[profile] one batch: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")
    print(f"[predict] vit_small + tf_decoder bf16 batch {B}: {N_BATCHES} batches in "
          f"{dt:.3f} s = {ips:.1f} images/s on this card; per batch encoder+bridge "
          f"{enc_ms:.2f} ms, greedy decoder {dec_ms:.2f} ms; launches attention {n_attn}, "
          f"layernorm {n_ln}")
    return counts


def encode_png(np, img):
    """uint8 RGB [H, W, 3] -> PNG bytes, by whichever of cv2 and PIL imports."""
    try:
        import cv2
    except ImportError:
        import io

        from PIL import Image

        out = io.BytesIO()
        Image.fromarray(img).save(out, format="PNG")
        return out.getvalue()
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    check(ok, "cv2.imencode failed")
    return buf.tobytes()


def word_image(np, rng, i):
    """A synthetic crop of a size a word image may have (24-72 x 40-360)."""
    return rng.integers(0, 256, (24 + 8 * (i % 7), 40 + 32 * (i % 11), 3), dtype=np.uint8)


def phase_host_images(np):
    """The host's resize: the port's numpy bicubic against the OpenCV that
    is installed here (if one is), within 1 grey level everywhere."""
    from dig_tpu_torch.data.images import cubic_resize_uint8

    rng = np.random.default_rng(4)
    imgs = [word_image(np, rng, i) for i in range(77)]
    t0 = time.perf_counter()
    got = [cubic_resize_uint8(img, 32, 128) for img in imgs]
    numpy_ms = (time.perf_counter() - t0) / len(imgs) * 1e3
    try:
        import cv2
    except ImportError:
        print(f"[host images] no cv2 here: the numpy bicubic runs, {numpy_ms:.3f} ms an image "
              f"(host, one thread); not compared")
        return
    t0 = time.perf_counter()
    want = [cv2.resize(img, (128, 32), interpolation=cv2.INTER_CUBIC) for img in imgs]
    cv_ms = (time.perf_counter() - t0) / len(imgs) * 1e3
    diff = np.abs(np.stack(got).astype(np.int16) - np.stack(want).astype(np.int16))
    check(int(diff.max()) <= 1, f"the numpy bicubic is {int(diff.max())} grey levels from cv2's")
    print(f"[host images] numpy bicubic vs cv2 {cv2.__version__} INTER_CUBIC, {len(imgs)} images "
          f"to 32 x 128: max diff {int(diff.max())}, equal share {float((diff == 0).mean()):.6f}; "
          f"numpy {numpy_ms:.3f} ms, cv2 {cv_ms:.3f} ms an image (host, one thread)")


def phase_predict_cli(torch, np):
    """The predict CLI as a user calls it, on image files and an LMDB with
    a corrupt record, reference flag spelling included: full-width model,
    random weights from the seed, bf16, batch 512."""
    import tempfile

    from dig_tpu_torch.cli.run_predict import iter_lmdb_batches
    from dig_tpu_torch.cli.run_predict import main as predict_main
    from dig_tpu_torch.config import parse_config
    from dig_tpu_torch.data.lmdb_store import LmdbWriter, native_lib

    native_lib()  # built here (g++), so that the decode timing below does not hold the build
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as d:
        db, files, tsv = (os.path.join(d, n) for n in ("words", "crops", "out.tsv"))
        with LmdbWriter(db) as w:
            for i in range(1, CLI_RECORDS + 1):
                w.put(b"image-%09d" % i, encode_png(np, word_image(np, rng, i)))
            w.put(b"image-%09d" % (CLI_RECORDS + 1), b"not an image")
            w.put(b"num-samples", str(CLI_RECORDS + 1).encode())
        os.mkdir(files)
        for i in range(CLI_FILES):
            with open(os.path.join(files, f"crop{i}.png"), "wb") as f:
                f.write(encode_png(np, word_image(np, rng, i)))
        cfg = parse_config(argv=["--images", files, "--data_path", db, "--output", tsv,
                                 "--batch_size", str(B), "--decoder_type", "tf_decoder"])
        check(cfg.model_kind == "rec" and cfg.data_path == [db], f"config {cfg}")
        t0 = time.perf_counter()
        decoded = sum(len(names) for names, _ in iter_lmdb_batches([db], B, cfg, cfg.num_workers))
        host_s = time.perf_counter() - t0
        check(decoded == CLI_RECORDS, f"decoded {decoded} of {CLI_RECORDS} records")
        reset_counts()
        t0 = time.perf_counter()
        n = predict_main(cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        with open(tsv) as f:
            lines = f.read().splitlines()
    # the files' short batch, then the LMDB's batches: each padded to B
    batches = 1 + -(-CLI_RECORDS // B)
    want = per_step(attention_lse_fwd=12 * batches, layer_norm_fwd=24 * batches)
    check(counts == want, f"predict CLI launches {counts} != {want}")
    check(n == len(lines) == CLI_FILES + CLI_RECORDS, f"{n} recognized, {len(lines)} lines")
    names = [os.path.join(files, f"crop{i}.png") for i in range(CLI_FILES)] + \
            [f"{db}#{i}" for i in range(1, CLI_RECORDS + 1)]
    for line, name in zip(lines, names):
        fields = line.split("\t")
        check(len(fields) == 3 and fields[0] == name, f"TSV line {line!r} for {name}")
        check(0.0 < float(fields[2]) <= 1.0, f"confidence {fields[2]}")
    print(f"[predict cli] {CLI_FILES} files + an LMDB of {CLI_RECORDS} records and a corrupt one, "
          f"--decoder_type tf_decoder, bf16 batch {B}: {n} lines in {dt:.3f} s (model build "
          f"included); host decode + resize alone {CLI_RECORDS / host_s:.1f} images/s on "
          f"{cfg.num_workers} threads; launches attention {counts['attention_lse_fwd']}, "
          f"layernorm {counts['layer_norm_fwd']}")
    return counts


def write_word_lmdb(np, path, n, seed):
    """An LMDB of `n` seeded PNG word images in the reference schema."""
    from dig_tpu_torch.data.lmdb_store import LmdbWriter

    rng = np.random.default_rng(seed)
    with LmdbWriter(path) as w:
        for i in range(1, n + 1):
            w.put(b"image-%09d" % i, encode_png(np, word_image(np, rng, i)))
        w.put(b"num-samples", str(n).encode())


def phase_device_view(torch, np, db):
    """`make_device_view_fn` on one loader batch of 128: what it returns,
    its time, and the card against the CPU under one set of draws."""
    from dig_tpu_torch.data.dataset import build_pretraining_dataset
    from dig_tpu_torch.data.device_aug import affine_mats, batched_affine_warp, draw_augment_params
    from dig_tpu_torch.data.pipeline import make_train_loader
    from dig_tpu_torch.train.pretrain import make_device_view_fn
    from dig_tpu_torch.utils.profiling import profile_fn
    from dig_tpu_torch.utils.rng import step_generator

    ds = build_pretraining_dataset([db], num_view=1, rng=np.random.default_rng(0))
    loader = make_train_loader(ds, local_batch=PRE_BATCH, rank=0, world=1, seed=0, num_workers=4)
    u8 = torch.from_numpy(next(iter(loader))[0])
    check(u8.shape == (PRE_BATCH, 32, 128, 3) and u8.dtype == torch.uint8, f"batch {u8.shape}")
    view_fn = make_device_view_fn(L, 0.7, 2)
    x = u8.cuda()
    out = view_fn(step_generator(1, 1, 0, "cuda"), x)
    check(sorted(out) == ["aug_images", "images", "mask"], f"view keys {sorted(out)}")
    check(all(t.is_cuda for t in out.values()), "the view generator left the card")
    check(out["mask"].shape == (PRE_BATCH, 2, L) and out["mask"].dtype == torch.bool
          and bool((out["mask"].sum(-1) == PRE_MASKED).all()),
          f"masks are not {PRE_MASKED} of {L} in each view")
    aug = out["aug_images"]
    check(aug.shape == out["images"].shape == (PRE_BATCH, 32, 128, 3)
          and bool(torch.isfinite(aug).all()) and float(aug.abs().max()) <= 1.0,
          "the augmented view is not a finite image in [-1, 1]")
    changed = int((aug != out["images"]).flatten(1).any(1).sum())
    check(changed >= PRE_BATCH * 0.9, f"only {changed} of {PRE_BATCH} views were augmented")
    again = view_fn(step_generator(1, 1, 0, "cuda"), x)
    check(all(torch.equal(out[k], again[k]) for k in out), "one (seed, stream, step), two batches")

    params = draw_augment_params(torch.Generator().manual_seed(0), PRE_BATCH, 32, 128)
    on_cpu = view_fn(torch.Generator().manual_seed(1), u8, params)
    on_card = view_fn(torch.Generator(device="cuda").manual_seed(1), x, params)
    check(on_card["aug_images"].dtype == torch.float32, "the parity check is not fp32")
    # both map uint8 through the same table (ops/images.py): equal
    ierr = max_err(on_card["images"].cpu(), on_cpu["images"])
    check(ierr == 0.0, f"the original views differ by {ierr}")
    err = max_err(on_card["aug_images"].cpu(), on_cpu["aug_images"])
    check(err <= VIEW_ATOL, f"augmented view, card vs CPU: max abs err {err} > {VIEW_ATOL}")
    mats = affine_mats(*(params[k] for k in ("angle", "scale", "shear", "tx", "ty")), 32, 128)
    werr = max_err(batched_affine_warp(on_cpu["images"].cuda(), mats.cuda()).cpu(),
                   batched_affine_warp(on_cpu["images"], mats))
    check(werr <= WARP_ATOL, f"the warp, card vs CPU from one set of matrices: {werr} > {WARP_ATOL}")
    gates = {k: int(v.sum()) for k, v in params.items() if k.endswith("_gate")}

    steps = iter(range(1, 1000))
    ms = time_ms(lambda: view_fn(step_generator(1, 1, next(steps), "cuda"), x), iters=20)
    _, busy_ms, wall_ms = profile_fn(lambda: view_fn(step_generator(1, 1, 0, "cuda"), x))
    print(f"[device view] batch {PRE_BATCH}, uint8 -> images, aug_images, mask [{PRE_BATCH}, 2, {L}] "
          f"with {PRE_MASKED} masked a view; {changed} views changed; fp32 card vs CPU under one "
          f"set of draws (gates on: {gates}): max abs err {err:.3e} (atol {VIEW_ATOL}; the "
          f"original view {ierr:.3e}; the warp alone from one set of matrices {werr:.3e}, atol "
          f"{WARP_ATOL}); "
          f"{ms:.3f} ms a batch (CUDA events, 20 batches); one profiled batch: device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall")


def phase_loader(torch, np, d):
    """The loader alone over one epoch of the LMDB `d`/words: images/s with
    host SeqCLR augmentation and with `num_view=1` (what `--device_aug`
    reads), on 10 worker threads; and with host augmentation on 8 process
    workers started from this process, which has CUDA initialised
    (`phase_process_workers_under_cuda`)."""
    db = os.path.join(d, "words")
    import numpy

    from dig_tpu_torch.data.dataset import build_pretraining_dataset
    from dig_tpu_torch.data.pipeline import make_train_loader

    try:
        import cv2
        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = None
    check(cv2_version is not None, "host augmentation needs OpenCV (cv2), which is not installed")
    cores = len(os.sched_getaffinity(0))
    rates = {}
    for tag, num_view in (("host aug", 2), ("num_view=1", 1)):
        ds = build_pretraining_dataset([db], num_view=num_view, rng=np.random.default_rng(0))
        loader = make_train_loader(ds, local_batch=PRE_BATCH, rank=0, world=1, seed=0,
                                   num_workers=10)
        check(len(loader) == PRE_CLI_RECORDS // PRE_BATCH, f"{len(loader)} batches an epoch")
        t0 = time.perf_counter()
        batches = list(loader)
        dt = time.perf_counter() - t0
        check(len(batches) == len(loader), f"[loader {tag}] {len(batches)} batches")
        differ = 0
        for ori, aug, mask in batches:
            check(ori.shape == aug.shape == (PRE_BATCH, 32, 128, 3)
                  and ori.dtype == aug.dtype == np.uint8, f"[loader {tag}] {ori.shape} {ori.dtype}")
            check(mask.shape == (PRE_BATCH, num_view, L) and mask.dtype == np.bool_
                  and bool((mask.sum(-1) == PRE_MASKED).all()), f"[loader {tag}] masks {mask.shape}")
            differ += int((ori != aug).reshape(PRE_BATCH, -1).any(1).sum())
        if num_view == 2:  # this machine's OpenCV: the view must be an augmented one
            check(differ >= 0.9 * PRE_CLI_RECORDS, f"only {differ} augmented views differ")
        else:
            check(differ == 0, "num_view=1 must not augment on the host")
        rates[tag] = PRE_CLI_RECORDS / dt
    rates["host aug, 8 process workers"] = phase_process_workers_under_cuda(np, d)
    print(f"[loader] one epoch of {PRE_CLI_RECORDS} PNG records, batch {PRE_BATCH}, host clock, "
          f"pool start included; {cores} cores, numpy {numpy.__version__}, cv2 {cv2_version}, "
          f"Generator.spawn {hasattr(np.random.default_rng(0), 'spawn')}: "
          + "; ".join(f"{k}: {v:.1f} images/s" for k, v in rates.items())
          + " (10 worker threads unless said otherwise)")
    return rates


def epoch_rate(screen, epoch):
    """(seconds a step, seconds a step spent waiting for data) of `epoch`
    from the CLI's own screen.txt: the epoch's total and its last log line."""
    total = re.search(rf"Epoch: \[{epoch}\] Total time: \S+ \(([0-9.]+) s / it\)", screen)
    last = re.findall(rf"Epoch: \[{epoch}\] \[\d+/\d+\].*time: ([0-9.]+)  data: ([0-9.]+)", screen)
    check(total and last, f"screen.txt has no timing for epoch {epoch}")
    return float(total.group(1)), float(last[-1][1])


def run_pretrain_cli(torch, tag, argv, steps, cut_after_epoch=None, want=None):
    """`run_pretrain.main` on `argv`; checks the step count, the launch
    counts of every step, and that stdout came back.  With
    `cut_after_epoch`, the run is stopped by an exception from that epoch's
    log write, as a job killed after its checkpoint would be.  Returns
    (state or None, launch counts, seconds)."""
    from dig_tpu_torch.cli import run_pretrain
    from dig_tpu_torch.config import PretrainConfig, parse_config

    class Cut(Exception):
        pass

    real_write = run_pretrain.JsonlLogger.write

    def write(self, **stats):
        real_write(self, **stats)
        if stats["epoch"] == cut_after_epoch:
            raise Cut

    cfg = parse_config(PretrainConfig, argv)
    stdout = sys.stdout
    reset_counts()
    t0 = time.perf_counter()
    state = None
    if cut_after_epoch is None:
        state = run_pretrain.main(cfg)
    else:
        run_pretrain.JsonlLogger.write = write
        try:
            run_pretrain.main(cfg)
        except Cut:
            pass
        else:
            check(False, f"[{tag}] the run was not cut after epoch {cut_after_epoch}")
        finally:
            run_pretrain.JsonlLogger.write = real_write
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(sys.stdout is stdout, f"[{tag}] main left its tee on sys.stdout")
    if state is not None:
        check(state.step == state.optimizer.count == PRE_CLI_STEPS,
              f"[{tag}] {state.step} steps, want {PRE_CLI_STEPS}")
    check_counts(f"[{tag}]", counts, want or PER_STEP, steps)
    return state, counts, dt


def check_cli_outputs(out, tag):
    """log.txt (finite losses), both checkpoints with their commit marker, screen.txt."""
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    check([l["epoch"] for l in log] == list(range(PRE_CLI_EPOCHS)), f"[{tag}] log.txt epochs {log}")
    for l in log:
        for k in ("train_loss", "train_loss_contrast", "train_loss_pixel", "train_grad_norm"):
            check(math.isfinite(l[k]), f"[{tag}] {k} = {l[k]} in epoch {l['epoch']}")
    for epoch in range(PRE_CLI_EPOCHS):
        with open(os.path.join(out, f"checkpoint-{epoch}", "meta.json")) as f:
            meta = json.load(f)
        want = {"step": (epoch + 1) * PRE_CLI_STEPS // PRE_CLI_EPOCHS, "extra": {"epoch": epoch}}
        check(meta == want, f"[{tag}] checkpoint-{epoch} meta {meta}")
        check(os.path.getsize(os.path.join(out, f"checkpoint-{epoch}", "checkpoint.pth")) > 1e6,
              f"[{tag}] checkpoint-{epoch} has no payload")
    with open(os.path.join(out, "screen.txt")) as f:
        return log, f.read()


def phase_pretrain_cli(torch, np, db, out, tag, extra_argv):
    """`run_pretrain.main` as a user calls it: PretrainConfig defaults (the
    full-width model, bf16, batch 128, 10 loader threads), two epochs."""
    from dig_tpu_torch.cli.run_pretrain import build_model
    from dig_tpu_torch.config import PretrainConfig, parse_config

    argv = ["--image_alone_path", db, "--output_dir", out, "--epochs", str(PRE_CLI_EPOCHS),
            *extra_argv]
    cfg = parse_config(PretrainConfig, argv)
    check(cfg.batch_size == PRE_BATCH and cfg.dtype == "bfloat16" and cfg.num_workers == 10
          and cfg.model == "pretrain_simmim_moco_ori_vit_small_patch4_32x128", f"config {cfg}")
    state, counts, dt = run_pretrain_cli(torch, tag, argv, PRE_CLI_STEPS)
    log, screen = check_cli_outputs(out, tag)
    start = build_model(cfg, "cuda").state_dict()  # the same seed: the weights the run began with
    final = state.model.state_dict()
    moved = sum(not torch.equal(final[k], start[k]) for k in start)
    check(moved == len(start), f"[{tag}] {len(start) - moved} of {len(start)} tensors did not move")
    s_it, s_data = epoch_rate(screen, PRE_CLI_EPOCHS - 1)
    print(f"[{tag}] run_pretrain.main {' '.join(extra_argv) or '(host augmentation)'}, bf16 batch "
          f"{PRE_BATCH}, {PRE_CLI_EPOCHS} epochs of {PRE_CLI_STEPS // PRE_CLI_EPOCHS} steps in "
          f"{dt:.3f} s (model build and checkpoints included); the last epoch {s_it * 1e3:.1f} "
          f"ms a step = {PRE_BATCH / s_it:.1f} images/s by the CLI's own clock, its steps waiting "
          f"{s_data * 1e3:.1f} ms each for the loader; launches per step "
          f"{ {k: v // PRE_CLI_STEPS for k, v in counts.items() if v} }; epoch losses "
          f"{[round(l['train_loss'], 5) for l in log]}; {moved} tensors moved; checkpoint-0 and "
          f"checkpoint-1 written")
    del state, start, final
    torch.cuda.empty_cache()
    return counts


def phase_pretrain_resume(torch, np, db, root):
    """Resume equivalence on the card, fp32, `--device_aug`: two epochs
    straight (A) against one epoch, a fresh `main` that auto-resumes
    checkpoint-0, and the second epoch (B)."""
    tag = "pretrain cli resume"
    argv = lambda out: ["--image_alone_path", db, "--output_dir", os.path.join(root, out),
                        "--epochs", str(PRE_CLI_EPOCHS), "--device_aug", "--dtype", "float32"]
    half = PRE_CLI_STEPS // PRE_CLI_EPOCHS
    a, _, dt_a = run_pretrain_cli(torch, tag + " A", argv("resume_a"), PRE_CLI_STEPS)
    run_pretrain_cli(torch, tag + " B first epoch", argv("resume_b"), half, cut_after_epoch=0)
    b, _, _ = run_pretrain_cli(torch, tag + " B resumed", argv("resume_b"), PRE_CLI_STEPS - half)
    with open(os.path.join(root, "resume_b", "screen.txt")) as f:
        check("auto-resumed from" in f.read(), f"[{tag}] B did not auto-resume")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    check(not differ, f"[{tag}] {len(differ)} of {len(sa)} tensors differ, e.g. {differ[:4]}")
    oa = a.optimizer.inner.state_dict()["state"]
    ob = b.optimizer.inner.state_dict()["state"]
    check(sorted(oa) == sorted(ob) and len(oa) > 0, f"[{tag}] AdamW states {len(oa)} vs {len(ob)}")
    moments = 0
    for i in oa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(oa[i][name], ob[i][name]), f"[{tag}] AdamW {name} of parameter {i}")
            moments += 1
    momentum = sum(k.startswith(("momentum_", "pix_projector_m")) for k in sa)
    with open(os.path.join(root, "resume_a", "log.txt")) as fa, \
            open(os.path.join(root, "resume_b", "log.txt")) as fb:
        la, lb = fa.read(), fb.read()
    check(la == lb, f"[{tag}] the two runs' log.txt differ")
    print(f"[{tag}] fp32 --device_aug batch {PRE_BATCH}: {PRE_CLI_EPOCHS} epochs straight "
          f"({dt_a:.3f} s) vs 1 epoch + a fresh main auto-resuming checkpoint-0 + 1 epoch: "
          f"{len(sa)} tensors ({momentum} of the momentum branch) and {moments} AdamW moment and "
          f"step tensors equal bit for bit (torch.equal); log.txt equal byte for byte")
    ref = straight_run(a, la, dt_a)
    del a, b
    torch.cuda.empty_cache()
    return ref


def phase_pretrain_data(torch, np, paths):
    """The pre-training data path and CLI on one LMDB in a temporary
    directory, then the fine-tuning CLI, its encoder from the pre-training
    CLI's last checkpoint."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        db = os.path.join(d, "words")
        write_word_lmdb(np, db, PRE_CLI_RECORDS, 6)
        phase_device_view(torch, np, db)
        phase_loader(torch, np, d)
        paths["pretrain_cli"] = phase_pretrain_cli(
            torch, np, db, os.path.join(d, "host_aug"), "pretrain cli", [])
        paths["pretrain_cli_device_aug"] = phase_pretrain_cli(
            torch, np, db, os.path.join(d, "device_aug"), "pretrain cli device_aug",
            ["--device_aug"])
        pre_ref = phase_pretrain_resume(torch, np, db, d)
        phase_pretrain_cli_options(torch, np, db, d)
        phase_finetune_data(torch, np, d, paths,
                            os.path.join(d, "host_aug", f"checkpoint-{PRE_CLI_EPOCHS - 1}"),
                            db, pre_ref)


def phase_finetune_data(torch, np, d, paths, pre_ckpt, db, pre_ref):
    write_labelled_lmdb(np, os.path.join(d, "labelled"), FT_CLI_RECORDS, 7)
    write_labelled_lmdb(np, os.path.join(d, "labelled_eval"), FT_CLI_EVAL_RECORDS, 8)
    phase_device_abi_aug(torch, np, d)
    paths["finetune_cli"], ft_out = phase_finetune_cli(torch, np, d, pre_ckpt, "finetune cli", [])
    paths["finetune_cli_device_abi_aug"], _ = phase_finetune_cli(
        torch, np, d, pre_ckpt, "finetune cli device_abi_aug", ["--device_abi_aug"])
    paths["finetune_cli_resume"], ft_ref = phase_finetune_resume(torch, d, pre_ckpt)
    phase_finetune_resume(torch, d, pre_ckpt, ("--model_kind", "ctc"))
    phase_finetune_cli_opt(torch, d, pre_ckpt)
    paths["finetune_eval_sweep"] = phase_finetune_eval_sweep(torch, np, d, ft_out)
    paths["kinds_cli"] = phase_kinds_cli(torch, np, d, ft_out)
    phase_export_pth(torch, d, pre_ckpt, ft_out)
    paths["ddp_pretrain_cli"], paths["ddp_finetune_cli"] = phase_ddp_clis(
        torch, d, db, pre_ckpt, pre_ref, ft_ref)
    phase_sharded_cli(torch, d, db, pre_ckpt)


# ---------------------------------------------------------------------------
# data parallel: both training CLIs under torchrun, NCCL at world size 1
# ---------------------------------------------------------------------------

def straight_run(state, log_text, seconds):
    """What a straight fp32 run left, on the host: parameters (the momentum
    branch included), AdamW's per-parameter state, the accumulators,
    log.txt and its seconds."""
    inner = state.optimizer.inner.state_dict()["state"]
    return {"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "adamw": {i: {k: v.detach().cpu() for k, v in st.items()} for i, st in inner.items()},
            "acc": None if state.optimizer.acc is None
            else [a.detach().cpu() for a in state.optimizer.acc],
            "log": log_text, "seconds": seconds}


def ddp_child(spec_file):
    """The child that torchrun starts: each run of the JSON list in
    `spec_file` ({"kind", "argv", "out_file"}) in turn, through `ddp_run`."""
    with open(spec_file) as f:
        runs = json.load(f)
    for run in runs:
        ddp_run(run["kind"], run["out_file"], run["argv"])
    return 0


def ddp_run(kind, out_file, argv):
    """`run_<kind>.main(argv)` on the card, its rank and group from
    torchrun's variables (main makes the group and tears it down), with
    every step's (and every eval batch's) launches counted as in the
    one-process phases and the reducer and the collectives timed; what it
    found of the group, the counts, the timings and `straight_run` of its
    state go to `out_file`."""
    import torch

    sys.path.insert(0, ROOT)
    from dig_tpu_torch.cli import run_finetune, run_pretrain
    from dig_tpu_torch.config import FinetuneConfig, PretrainConfig, parse_config
    from dig_tpu_torch.parallel import dist as pdist

    module, config, step_factory = {
        "pretrain": (run_pretrain, PretrainConfig, "make_pretrain_step"),
        "finetune": (run_finetune, FinetuneConfig, "make_finetune_step")}[kind]
    group = {}
    real_init = module.init_distributed_mode

    def init(device):
        info = real_init(device)
        group.update(backend=info["backend"], world=pdist.get_world_size(),
                     rank=info["rank"], device=str(info["device"]), created=info["created"])
        return info

    module.init_distributed_mode = init
    # as main() sets them for the one-process runs that this one is held to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed = {"reduce": [], "all_reduce": [], "all_gather": []}

    def timing(key, fn):
        """`fn` with CUDA events on the current stream around each call and
        its host seconds."""
        def run(*args, **kwargs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t = time.perf_counter()
            ev[0].record()
            out = fn(*args, **kwargs)
            ev[1].record()
            timed[key].append((ev, time.perf_counter() - t))
            return out
        return run

    real = (pdist.GradientReducer.reduce, pdist.dist.all_reduce, pdist.dist.all_gather)
    pdist.GradientReducer.reduce = timing("reduce", real[0])
    pdist.dist.all_reduce = timing("all_reduce", real[1])
    pdist.dist.all_gather = timing("all_gather", real[2])
    steps, evals = [], []
    t0 = time.perf_counter()
    try:
        with counted_calls(module, step_factory, steps, sync=False), \
                counted_calls(run_finetune, "make_eval_step", evals, sync=True):
            state = module.main(parse_config(config, argv))
    finally:
        pdist.GradientReducer.reduce, pdist.dist.all_reduce, pdist.dist.all_gather = real
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    group["destroyed"] = not pdist.is_distributed()
    # (calls, card ms, host ms) of each: the reducer's all-reduce is among
    # the all-reduces too
    collectives = {k: (len(v), sum(e[0].elapsed_time(e[1]) for e, _ in v),
                       sum(h for _, h in v) * 1e3) for k, v in timed.items()}
    log = ""
    out = parse_config(config, argv).output_dir
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    torch.save({"group": group, "steps": [c for c, _ in steps], "evals": [c for c, _ in evals],
                "step": state.step, "count": state.optimizer.count, "collectives": collectives,
                "run": straight_run(state, log, dt)}, out_file)
    del state
    torch.cuda.empty_cache()


def run_ddp_clis(torch, d, runs):
    """One `python -m torch.distributed.run --nproc_per_node 1` of this
    script's `ddp_child` for `runs` ([(tag, kind, argv)]): each CLI over
    NCCL at world size 1, in turn in one process; each run's group checked.
    Returns ({tag: the run's results}, seconds of the whole call)."""
    import socket

    spec = [{"kind": kind, "argv": argv, "out_file": os.path.join(d, f"ddp_{i}.pt")}
            for i, (_, kind, argv) in enumerate(runs)]
    with open(os.path.join(d, "ddp_runs.json"), "w") as f:
        json.dump(spec, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.empty_cache()  # the child allocates on the same card
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           "1", "--master_addr", "127.0.0.1", "--master_port", str(port),
           os.path.abspath(__file__), "--ddp-child", os.path.join(d, "ddp_runs.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DDP_CHILD_TIMEOUT, cwd=ROOT)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"[ddp] torchrun exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    results = {}
    for (tag, _, _), run in zip(runs, spec):
        res = torch.load(run["out_file"], weights_only=False)
        g = res["group"]
        check(g["backend"] == "nccl" and g["world"] == 1 and g["rank"] == 0 and g["created"]
              and g["destroyed"] and g["device"] == "cuda:0", f"[{tag}] process group {g}")
        results[tag] = res
    return results, dt


def collectives_text(res, steps):
    """The reducer's and the collectives' cost a step in a torchrun child,
    on the card's clock (CUDA events on the step's stream) and the host's."""
    c = res["collectives"]
    n, card, host = c["reduce"]
    check(n == res["count"], f"the reducer ran {n} times for {res['count']} updates")
    return (f"the gradient reducer {card / n:.3f} ms on the card and {host / n:.3f} ms on the "
            f"host an update; all-reduces {c['all_reduce'][0] / steps:.1f} a step "
            f"({c['all_reduce'][1] / steps:.3f} ms card, {c['all_reduce'][2] / steps:.3f} ms "
            f"host, the reducer's and the per-epoch and print-step host reductions included), "
            f"all-gathers {c['all_gather'][0] / steps:.1f} a step "
            f"({c['all_gather'][1] / steps:.3f} ms card)")


def check_bit_equal(torch, tag, got, want):
    """A torchrun run's `straight_run` against the one-process one's."""
    differ = [k for k in want["model"] if not torch.equal(got["model"][k], want["model"][k])]
    check(not differ, f"[{tag}] {len(differ)} of {len(want['model'])} tensors differ from the "
          f"one-process run, e.g. {differ[:4]}")
    check(sorted(got["adamw"]) == sorted(want["adamw"]) and want["adamw"],
          f"[{tag}] AdamW states {len(got['adamw'])} vs {len(want['adamw'])}")
    moments = 0
    for i, st in want["adamw"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(got["adamw"][i][name], st[name]), f"[{tag}] AdamW {name} of {i}")
            moments += 1
    if want["acc"] is not None:
        check(len(got["acc"]) == len(want["acc"])
              and all(torch.equal(x, y) for x, y in zip(got["acc"], want["acc"])),
              f"[{tag}] accumulators")
    check(got["log"] == want["log"], f"[{tag}] log.txt differs from the one-process run's:\n"
          f"{got['log']}\n{want['log']}")
    return len(want["model"]), moments


def two_rank_steps(torch, np, rows):
    """One fp32 pre-training step and one fine-tuning step (rates 0) of the
    full-width models from seed 3, on `rows` of a global batch of
    TWO_RANK_BATCH, each step's launches asserted: (loss, gradients, the
    parameters after, the parameters before) of each, on the host."""
    out = {}
    for kind in ("pretrain", "finetune"):
        if kind == "pretrain":
            model, state, step, batch = pretrain_setup(torch, np, torch.float32, TWO_RANK_BATCH,
                                                       "cuda", seed=3)
            want, run = PER_STEP, lambda b: step(state, b)[1]
        else:
            model, state, step, batch, _ = finetune_setup(torch, np, torch.float32,
                                                          TWO_RANK_BATCH, "cuda", rates=False,
                                                          seed=3)
            want = FT_PER_STEP_RESUME
            run = lambda b: step(state, b, torch.Generator(device="cuda").manual_seed(0))[1]
        # AdamW's eps at 1e-3, as the CPU parity tests take it: at 1e-8 its
        # first step g / (|g| + eps) turns gradient elements that are zero but
        # for rounding, which two sums order differently, into full steps
        for group in state.optimizer.inner.param_groups:
            group["eps"] = 1e-3
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        reset_counts()
        metrics = run({k: v[rows] for k, v in batch.items()})
        torch.cuda.synchronize()
        check(read_counts() == want, f"[two ranks one card] {kind}: launches {read_counts()}")
        out[kind] = (float(metrics["loss"]),
                     {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
                     {k: v.detach().cpu() for k, v in model.state_dict().items()}, before)
        del model, state, step
        torch.cuda.empty_cache()
    return out


def gloo_child(root):
    """One of the two ranks that torchrun starts for `[two ranks one card]`:
    both on card 0, in a gloo group this process makes itself (NCCL takes
    one rank a device), so the port joins its caller's group; the rank's
    rows of the global batch through both steps."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        n = TWO_RANK_BATCH // world
        out = two_rank_steps(torch, np, slice(rank * n, (rank + 1) * n))
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    return 0


def phase_two_ranks_one_card(torch, np):
    """Two ranks on the one card, over gloo (separate from the NCCL path,
    which the port takes on a card: NCCL refuses two ranks on one device):
    each runs the full-width fp32 pre-training and fine-tuning steps on its
    half of a global batch of TWO_RANK_BATCH through the kernels, against
    one process on the whole batch: the mean loss within 1e-5, both ranks'
    reduced gradients equal to each other and within 1e-5 of each leaf's
    max (plus STEP_FLOOR of the largest) of one process's, the parameters
    after AdamW equal on both ranks and within 1e-3 of each tensor's
    largest step (plus its last bit) of one process's."""
    import tempfile

    tag = "two ranks one card"
    one = two_rank_steps(torch, np, slice(0, TWO_RANK_BATCH))
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.empty_cache()
        dt, _ = torchrun_children(tag, 2, ["--gloo-child", root])
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    worst = {}
    for kind in ("pretrain", "finetune"):
        (l0, g0, p0, _), (l1, g1, p1, _) = ranks[0][kind], ranks[1][kind]
        loss, grads, params, start = one[kind]
        check(abs((l0 + l1) / 2 - loss) <= 1e-5 * abs(loss),
              f"[{tag}] {kind}: mean loss {(l0 + l1) / 2} vs {loss}")
        floor = STEP_FLOOR * max(float(g.abs().max()) for g in grads.values())
        check(sorted(g0) == sorted(grads), f"[{tag}] {kind}: gradient leaves differ")
        err_g = 0.0
        for name, g in grads.items():
            check(torch.equal(g0[name], g1[name]), f"[{tag}] {kind}: {name}: ranks differ")
            err = float((g0[name] - g).abs().max())
            check(err <= 1e-5 * float(g.abs().max()) + floor,
                  f"[{tag}] {kind}: gradient {name}: max abs err {err}")
            err_g = max(err_g, err / max(float(g.abs().max()), 1e-30))
        err_p = 0.0
        for name, v in params.items():
            check(torch.equal(p0[name], p1[name]), f"[{tag}] {kind}: parameter {name}: ranks differ")
            err = float((p0[name] - v).abs().max())
            check(err <= 1e-3 * float((v - start[name]).abs().max())
                  + float(np.spacing(np.float32(v.abs().max()))),
                  f"[{tag}] {kind}: parameter {name}: max abs err {err}")
            err_p = max(err_p, err)
        worst[kind] = (err_g, err_p, len(grads))
    print(f"[{tag}] gloo, 2 ranks on cuda:0 (a group made by the caller; the port's own "
          f"card path is NCCL), fp32 full width, global batch {TWO_RANK_BATCH} as 2 x "
          f"{TWO_RANK_BATCH // 2}, the kernels at their per-step counts on each rank, against "
          f"one process on the whole batch: " + "; ".join(
              f"{k}: loss within 1e-5, {n} reduced gradients equal on both ranks, worst "
              f"{eg:.2e} of a leaf's max, parameters after AdamW within {ep:.2e}"
              for k, (eg, ep, n) in worst.items()) + f"; torchrun call {dt:.1f} s")


# ---------------------------------------------------------------------------
# parameter sharding: torchrun children over gloo, all on the one card
# ---------------------------------------------------------------------------

SHARDED_STEPS = 1  # bf16 steps a mesh and a trainer
SHARDED_FP32_BATCH = 8  # the fp32 checks' global batch
SHARDED_FP32_DEPTH = 4  # the fp32 pre-training check's encoder depth (full width)
# (mesh, the trainers it runs); the meshes of one world size share a torchrun call
SHARDED_MESHES = (("1x2x1", ("pretrain", "finetune")), ("1x1x2", ("pretrain", "finetune")),
                  ("1x2x2", ("pretrain",)))
NOT_SCALING = "gloo via host; not a scaling figure"


def mesh_of(spec):
    return tuple(int(a) for a in spec.split("x"))


def torchrun_children(tag, nproc, args, timeout=DDP_CHILD_TIMEOUT):
    """This script under torchrun with `nproc` ranks and `args`; fails the
    phase on a non-zero exit.  Returns (seconds, stdout)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
         str(nproc), "--master_addr", "127.0.0.1", "--master_port", str(port),
         os.path.abspath(__file__), *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"[{tag}] torchrun exited {proc.returncode}:\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return dt, proc.stdout


def sharded_child(root):
    """One rank of a sharded phase, started by torchrun: card 0, a gloo
    group this process makes (NCCL takes one rank a device), the job of
    ``root/spec.json``; its results to ``root/rank<r>.pt``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = sharded_cli_job(torch, spec) if spec["job"] == "cli" else \
            sharded_step_job(torch, np, spec)
    finally:
        from dig_tpu_torch.parallel.mesh import clear_mesh

        clear_mesh()
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    return 0


def rank_rows(torch, batch_np, mesh):
    """This rank's share of a global batch (as its loader gives it) on the
    card, then its tensor group's rows (`shard_batch`)."""
    from dig_tpu_torch.parallel.mesh import shard_batch

    def rows(v):
        n = v.shape[0] // mesh.world
        return torch.from_numpy(v[mesh.rank * n:(mesh.rank + 1) * n]).cuda()

    return shard_batch({k: rows(v) for k, v in batch_np.items()})


def held_bytes(model, opt):
    """(bytes of the rank's parameters, of AdamW's moments): every tensor
    but AdamW's step counts."""
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = sum(st[k].numel() * st[k].element_size() for st in opt.inner.state.values()
                  for k in ("exp_avg", "exp_avg_sq"))
    return params, moments


def replicated_digests(model):
    """sha1 of each replicated parameter's bytes: tensor peers must agree."""
    import hashlib

    return {n: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters() if getattr(p, "shard_spec", None) is None}


def whole_grads(torch, model):
    """Every gradient whole (a sharded parameter's gathered: a collective)."""
    out = {}
    for n, p in model.named_parameters():
        if p.grad is None:
            continue
        spec = getattr(p, "shard_spec", None)
        out[n] = (p.grad if spec is None else spec.gather_full(p.grad)).detach().cpu()
    return out


def sharded_setup(torch, np, kind, dtype, batch, mesh, **kw):
    """(model, state, run(batch, i) -> metrics, global batch, launches a step)
    of a trainer at full width on `mesh` (None: one process)."""
    from dig_tpu_torch.utils.rng import step_generator

    dp = 0 if mesh is None else mesh.dp_index
    if kind == "pretrain":
        model, state, step, batch_np = pretrain_setup(torch, np, dtype, batch, "cuda", mesh=mesh,
                                                      **kw)
        depth = model.encoder.depth
        want = {k: v * depth // 12 for k, v in PER_STEP.items()}
        return model, state, lambda b, i: step(state, b)[1], batch_np, want
    rates = kw.pop("rates", True)
    model, state, step, batch_np, _ = finetune_setup(torch, np, dtype, batch, "cuda", rates=rates,
                                                     mesh=mesh, **kw)
    want = FT_PER_STEP if rates else FT_PER_STEP_RESUME

    def run(b, i):
        return step(state, b, step_generator(0, 0, i, "cuda", dp))[1]

    return model, state, run, batch_np, want


def sharded_bf16(torch, np, kind, mesh):
    """SHARDED_STEPS bf16 steps at full width on this rank's rows."""
    batch = PRE_BATCH if kind == "pretrain" else FT_BATCH
    model, state, run, batch_np, want = sharded_setup(torch, np, kind, torch.bfloat16, batch,
                                                      mesh)
    local = rank_rows(torch, batch_np, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, times = [], []
    for i in range(SHARDED_STEPS):
        t0 = time.perf_counter()
        m = run(local, i)
        metrics.append({k: float(v) for k, v in m.items()})  # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    attn = model.encoder.blocks[0].attn
    return {"counts": counts, "want": want, "metrics": metrics, "ms": times,
            "peak": torch.cuda.max_memory_allocated(), "held": held_bytes(model, state.optimizer),
            "predicted": model.predicted_bytes, "replicated": replicated_digests(model),
            "heads": (attn.num_heads // attn.tp.size if attn.tp is not None else attn.num_heads),
            "rows": int(local["images"].shape[0])}


def sharded_fp32(torch, np, kind, mesh):
    """One fp32 step at SHARDED_FP32_BATCH (the pre-training encoder at
    SHARDED_FP32_DEPTH blocks; fine-tuning with every rate 0, so that #3 /
    #4 run on the rank's heads), AdamW's eps at 1e-3 as [two ranks one
    card] takes it; on `mesh`, this rank's rows (None: one process, all)."""
    from dig_tpu_torch.parallel.sharding import full_state_dict

    kw = dict(seed=3, encoder_depth=SHARDED_FP32_DEPTH) if kind == "pretrain" else \
        dict(seed=3, rates=False)
    model, state, run, batch_np, want = sharded_setup(torch, np, kind, torch.float32,
                                                      SHARDED_FP32_BATCH, mesh, **kw)
    for group in state.optimizer.inner.param_groups:
        group["eps"] = 1e-3
    before = ({k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
              if mesh is None else None)
    batch = ({k: torch.from_numpy(v).cuda() for k, v in batch_np.items()} if mesh is None
             else rank_rows(torch, batch_np, mesh))
    reset_counts()
    loss = float(run(batch, 0)["loss"])
    counts = read_counts()
    grads = whole_grads(torch, model)
    params = {k: v.cpu() for k, v in full_state_dict(model).items()}
    keep = mesh is None or mesh.rank == 0
    return {"loss": loss, "counts": counts, "want": want, "grads": grads if keep else None,
            "params": params if keep else None, "before": before}


def sharded_step_job(torch, np, spec):
    """Each mesh of ``spec["meshes"]`` in turn, its groups made anew."""
    from dig_tpu_torch.parallel.mesh import clear_mesh, create_mesh

    out = {}
    for name, kinds in spec["meshes"]:
        d, f, t = mesh_of(name)
        mesh = create_mesh(f, t, d)
        res = out[name] = {"coords": (mesh.data, mesh.fsdp, mesh.tensor)}
        for kind in kinds:
            res[kind] = sharded_bf16(torch, np, kind, mesh)
            torch.cuda.empty_cache()
            res[kind + "_fp32"] = sharded_fp32(torch, np, kind, mesh)
            torch.cuda.empty_cache()
        clear_mesh()
    return out


def check_fp32_against_one(tag, ranks, one, dp_loss):
    """The [two ranks one card] bounds: the mean loss over the data-parallel
    ranks within 1e-5 of one process's; rank 0's whole gradients within
    1e-5 of each leaf's max (plus STEP_FLOOR of the largest), the whole
    parameters after AdamW within 1e-3 of each tensor's largest step (plus
    its last bit).  Returns (worst gradient, worst parameter error)."""
    import numpy as np

    check(abs(dp_loss - one["loss"]) <= 1e-5 * abs(one["loss"]),
          f"[{tag}] mean loss {dp_loss} vs one process's {one['loss']}")
    got, want = ranks[0]["grads"], one["grads"]
    check(sorted(got) == sorted(want), f"[{tag}] gradient leaves differ")
    floor = STEP_FLOOR * max(float(g.abs().max()) for g in want.values())
    err_g = 0.0
    for name, g in want.items():
        err = float((got[name] - g).abs().max())
        check(err <= 1e-5 * float(g.abs().max()) + floor, f"[{tag}] gradient {name}: {err}")
        err_g = max(err_g, err / max(float(g.abs().max()), 1e-30))
    err_p = 0.0
    for name, v in one["params"].items():
        err = float((ranks[0]["params"][name] - v).abs().max())
        check(err <= 1e-3 * float((v - one["before"][name]).abs().max())
              + float(np.spacing(np.float32(v.abs().max()))),
              f"[{tag}] parameter {name}: max abs err {err}")
        err_p = max(err_p, err)
    return err_g, err_p


def phase_sharded_steps(torch, np):
    """`[sharded pretrain one card]` and `[sharded finetune one card]`:
    each mesh of SHARDED_MESHES as torchrun children over gloo on card 0
    (NCCL refuses two ranks a device), the full-width trainers with their
    parameters, momentum branch and AdamW state sharded by the rules
    (`parallel/sharding.py`).  bf16, SHARDED_STEPS steps at the global batch
    (128 pre-training, 256 fine-tuning at FinetuneConfig defaults): each
    rank's launches a step, loss and grad norm finite, the grad norm equal
    on every rank and the loss on tensor peers, tensor peers' replicated
    parameters bit-equal, each rank's parameter + AdamW bytes equal to the
    share the rules predict, peak memory, ms a step.  fp32 at a global batch
    of SHARDED_FP32_BATCH against one process on the whole batch
    (`check_fp32_against_one`)."""
    import tempfile

    one = {kind: sharded_fp32(torch, np, kind, None) for kind in ("pretrain", "finetune")}
    for kind, res in one.items():
        check(res["counts"] == res["want"], f"[sharded {kind}] one process: {res['counts']}")
    torch.cuda.empty_cache()
    by_world = {}
    for spec, kinds in SHARDED_MESHES:
        by_world.setdefault(math.prod(mesh_of(spec)), []).append((spec, kinds))
    results = {}
    for world, meshes in by_world.items():
        with tempfile.TemporaryDirectory() as root:
            with open(os.path.join(root, "spec.json"), "w") as fh:
                json.dump({"job": "steps", "meshes": meshes}, fh)
            dt, _ = torchrun_children(f"sharded {world} ranks", world, ["--sharded-child", root])
            ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                     for r in range(world)]
        for spec, kinds in meshes:
            results[spec] = (kinds, [r[spec] for r in ranks], dt)
    for spec, (kinds, ranks, dt) in results.items():
        world = len(ranks)
        for kind in kinds:
            tag = f"sharded {kind} one card"
            res = [r[kind] for r in ranks]
            for r, x in enumerate(res):
                for name, n in x["want"].items():
                    check(x["counts"][name] == n * SHARDED_STEPS,
                          f"[{tag}] {spec} rank {r} {name}: {x['counts'][name]} launches in "
                          f"{SHARDED_STEPS} steps, want {n} a step")
                for m in x["metrics"]:
                    check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                          f"[{tag}] {spec} rank {r}: {m}")
                check(x["held"] == tuple(x["predicted"]),
                      f"[{tag}] {spec} rank {r}: holds {x['held']} bytes, the rules predict "
                      f"{x['predicted']}")
            for i in range(SHARDED_STEPS):
                norms = {x["metrics"][i]["grad_norm"] for x in res}
                check(len(norms) == 1, f"[{tag}] {spec} step {i}: grad norms {norms}")
            peers = {}
            for r, x in zip(ranks, res):
                peers.setdefault(tuple(r["coords"][:2]), []).append(x)
            for group in peers.values():
                a = group[0]
                for b in group[1:]:
                    check([m["loss"] for m in a["metrics"]] == [m["loss"] for m in b["metrics"]],
                          f"[{tag}] {spec}: tensor peers' losses differ")
                    differ = [n for n in a["replicated"] if a["replicated"][n] != b["replicated"][n]]
                    check(not differ, f"[{tag}] {spec}: tensor peers' replicated parameters "
                          f"differ: {differ[:4]}")
            dp_loss = [statistics.mean(g[0]["metrics"][i]["loss"] for g in peers.values())
                       for i in range(SHARDED_STEPS)]
            fp = [r[kind + "_fp32"] for r in ranks]
            for r, x in enumerate(fp):
                check(x["counts"] == x["want"], f"[{tag}] {spec} rank {r} fp32: {x['counts']}")
            fp_peers = {}
            for r, x in zip(ranks, fp):
                fp_peers.setdefault(tuple(r["coords"][:2]), x["loss"])
            err_g, err_p = check_fp32_against_one(f"{tag} {spec} fp32", fp, one[kind],
                                                  statistics.mean(fp_peers.values()))
            x = res[0]
            print(f"[{tag}] mesh {spec} ({world} ranks, gloo on cuda:0), {x['rows']} rows a "
                  f"tensor group, attention on {x['heads']} heads a rank: launches a step "
                  f"{launches_text({k: v // SHARDED_STEPS for k, v in x['counts'].items()})} on "
                  f"every rank; losses {[round(v, 4) for v in dp_loss]} (data-parallel mean), "
                  f"grad norms {[round(m['grad_norm'], 4) for m in x['metrics']]} equal on every "
                  f"rank; {len(x['replicated'])} replicated tensors bit-equal on tensor peers; "
                  f"parameter + AdamW bytes a rank "
                  f"{[sum(y['held']) for y in res]} = the rules' share "
                  f"{[sum(y['predicted']) for y in res]}; peak memory a rank "
                  f"{[round(y['peak'] / 2**30, 2) for y in res]} GiB; ms a step "
                  f"{[[round(v, 1) for v in y['ms']] for y in res]} ({NOT_SCALING}); fp32 "
                  f"global batch {SHARDED_FP32_BATCH}"
                  f"{f', depth {SHARDED_FP32_DEPTH}' if kind == 'pretrain' else ', rates 0'} "
                  f"against one process: loss within 1e-5, gradients worst {err_g:.2e} of a "
                  f"leaf's max, parameters after AdamW within {err_p:.2e}; the torchrun call of "
                  f"{dt:.1f} s")


def sharded_cli_job(torch, spec):
    """[sharded cli]'s ranks: `run_pretrain.main` with --n_fsdp 2, then
    `run_finetune.main` with --n_tensor 2, each under this group."""
    _, counts, dt_pre = run_pretrain_cli(torch, "sharded cli pretrain", spec["pretrain"],
                                         PRE_CLI_STEPS)
    state, steps, evals, _, dt_ft = run_finetune_cli(torch, "sharded cli finetune",
                                                     spec["finetune"])
    check_each("sharded cli finetune", "step", steps, FT_PER_STEP)
    check_each("sharded cli finetune", "eval batch", evals, FT_EVAL_BATCH)
    return {"pretrain_s": dt_pre, "finetune_s": dt_ft, "steps": len(steps), "evals": len(evals),
            "finetune_step": state.step}


def eval_line(screen, path):
    return [x for x in screen.splitlines() if x.startswith(f"* {path}:")][-1]


def phase_sharded_cli(torch, d, db, pre_ckpt):
    """`[sharded cli]`: on two gloo ranks on the card, `run_pretrain.main`
    with --n_fsdp 2 at PretrainConfig defaults (64 rows a rank: the global
    batch 128) for PRE_CLI_EPOCHS epochs on the 512-PNG LMDB, then
    `run_finetune.main` with --n_tensor 2 (128 rows a rank) from
    [pretrain cli]'s checkpoint for one epoch and its eval.  A one-process
    run then auto-resumes the sharded pre-training's last checkpoint, and
    its tensors must equal the file's bit for bit; a one-process `--eval`
    of the sharded fine-tuning's checkpoint must give the run's eval line
    (accuracy, loss and F-measure to the printed 4 decimals): the eval
    pass gathers the sharded parameters and runs every layer whole, in the
    same batches, so nothing of the mesh reaches its sums."""
    import tempfile

    from dig_tpu_torch.cli import run_finetune, run_pretrain
    from dig_tpu_torch.config import FinetuneConfig, PretrainConfig, parse_config
    from dig_tpu_torch.utils.checkpoint import restore_checkpoint

    tag = "sharded cli"
    out_pre, out_ft = os.path.join(d, "sharded_pre"), os.path.join(d, "sharded_ft")
    pre_argv = ["--image_alone_path", db, "--output_dir", out_pre, "--epochs",
                str(PRE_CLI_EPOCHS), "--batch_size", str(PRE_BATCH // 2), "--n_fsdp", "2"]
    ft_common = ["--data_path", os.path.join(d, "labelled"), "--eval_data_path",
                 os.path.join(d, "labelled_eval"), "--batch_size", str(FT_BATCH // 2)]
    ft_argv = ft_common + ["--finetune", pre_ckpt, "--output_dir", out_ft, "--epochs", "1",
                           "--n_tensor", "2"]
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "spec.json"), "w") as fh:
            json.dump({"job": "cli", "pretrain": pre_argv, "finetune": ft_argv}, fh)
        dt, _ = torchrun_children(tag, 2, ["--sharded-child", root])
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    log, screen = check_cli_outputs(out_pre, tag)
    check("mesh: {'data': 1, 'fsdp': 2, 'tensor': 1}" in screen, f"[{tag}] no mesh line")
    # one process resumes the last checkpoint: nothing left to train
    last = os.path.join(out_pre, f"checkpoint-{PRE_CLI_EPOCHS - 1}")
    state = run_pretrain.main(parse_config(PretrainConfig, [
        "--image_alone_path", db, "--output_dir", out_pre, "--epochs", str(PRE_CLI_EPOCHS)]))
    saved = restore_checkpoint(last)
    live = state.model.state_dict()
    differ = [k for k, v in saved["model"].items() if not torch.equal(live[k].cpu(), v)]
    check(not differ and len(live) == len(saved["model"]),
          f"[{tag}] {len(differ)} tensors differ from {os.path.basename(last)}: {differ[:4]}")
    moments = state.optimizer.state_dict()["inner"]["state"]
    file_moments = saved["optimizer"]["inner"]["state"]
    check(all(torch.equal(moments[i][k].cpu(), file_moments[i][k]) for i in file_moments
              for k in ("exp_avg", "exp_avg_sq")), f"[{tag}] AdamW moments differ from the file")
    check(state.step == PRE_CLI_STEPS, f"[{tag}] the resumed run trained ({state.step} steps)")
    del state
    torch.cuda.empty_cache()
    with open(os.path.join(out_ft, "screen.txt")) as fh:
        ft_screen = fh.read()
    check("mesh: {'data': 1, 'fsdp': 1, 'tensor': 2}" in ft_screen, f"[{tag}] no mesh line")
    with open(os.path.join(out_ft, "log.txt")) as fh:
        ft_log = [json.loads(line) for line in fh]
    check(len(ft_log) == 1 and math.isfinite(ft_log[0]["train_loss"]), f"[{tag}] {ft_log}")
    eval_dir = os.path.join(d, "sharded_ft_eval")
    results = run_finetune.main(parse_config(FinetuneConfig, ft_common + [
        "--eval", "--resume", os.path.join(out_ft, "checkpoint-0"), "--output_dir", eval_dir]))
    with open(os.path.join(eval_dir, "screen.txt")) as fh:
        one_line = eval_line(fh.read(), os.path.join(d, "labelled_eval"))
    run_line = eval_line(ft_screen, os.path.join(d, "labelled_eval"))
    check(results[0]["acc"] == ft_log[0]["val_acc"] and one_line == run_line,
          f"[{tag}] eval: the run's {run_line!r} vs one process's {one_line!r}")
    r = ranks[0]
    print(f"[{tag}] 2 gloo ranks on cuda:0 ({NOT_SCALING}): run_pretrain.main --n_fsdp 2, "
          f"{PRE_CLI_EPOCHS} epochs of {PRE_CLI_STEPS // PRE_CLI_EPOCHS} steps at 2 x "
          f"{PRE_BATCH // 2} rows in {r['pretrain_s']:.1f} s, launches {launches_text(PER_STEP)} "
          f"a step on each rank, epoch losses {[round(l['train_loss'], 4) for l in log]}; a "
          f"one-process run auto-resumed {os.path.basename(last)}: {len(live)} tensors and the "
          f"AdamW moments equal to the file bit for bit; run_finetune.main --n_tensor 2 from "
          f"[pretrain cli]'s checkpoint, 1 epoch of {r['steps']} steps at 2 x {FT_BATCH // 2} "
          f"rows + {r['evals']} eval batches in {r['finetune_s']:.1f} s; its eval line equal to "
          f"one process's --eval of its checkpoint-0: {run_line.split(': ', 1)[1]}; torchrun "
          f"call {dt:.1f} s")


def phase_ddp_clis(torch, d, db, pre_ckpt, pre_ref, ft_ref):
    """Both training CLIs under torchrun at world size 1 over NCCL, in one
    torchrun call: `[ddp pretrain cli]`, PretrainConfig defaults with
    `--device_aug` (bf16, 2 epochs); `[ddp pretrain cli resume argv]`,
    `[pretrain cli resume]`'s fp32 argv; `[ddp finetune cli]`, `[finetune
    cli]`'s argv with `--dist_eval` (bf16, the encoder from the pre-training
    CLI's checkpoint, 2 epochs, eval after each); `[ddp finetune cli resume
    argv]`, `[finetune cli resume]`'s fp32 argv with `--update_freq 2`.  The
    launches of every step and eval batch asserted, the bf16 runs' ms a step
    beside the one-process runs' of this script, the fp32 runs equal bit
    for bit to the one-process straight runs.  Returns the launch counts of
    the two bf16 runs."""
    ft_data = ["--data_path", os.path.join(d, "labelled"), "--finetune", pre_ckpt,
               "--epochs", str(FT_CLI_EPOCHS)]
    runs = [
        ("ddp pretrain cli", "pretrain", [
            "--image_alone_path", db, "--output_dir", os.path.join(d, "ddp_device_aug"),
            "--epochs", str(PRE_CLI_EPOCHS), "--device_aug"]),
        ("ddp pretrain cli resume argv", "pretrain", [
            "--image_alone_path", db, "--output_dir", os.path.join(d, "ddp_resume"),
            "--epochs", str(PRE_CLI_EPOCHS), "--device_aug", "--dtype", "float32"]),
        ("ddp finetune cli", "finetune", [
            *ft_data, "--eval_data_path", os.path.join(d, "labelled_eval"), "--output_dir",
            os.path.join(d, "ddp_finetune"), "--dist_eval"]),
        ("ddp finetune cli resume argv", "finetune", [
            *ft_data, "--output_dir", os.path.join(d, "ddp_ft_resume"), "--dtype", "float32",
            "--attn_drop_rate", "0", "--update_freq", "2", "--device_abi_aug"]),
    ]
    res, dt = run_ddp_clis(torch, d, runs)
    print(f"[ddp] one torchrun --nproc_per_node 1 call ran the four CLI runs below in "
          f"{dt:.1f} s, its start, imports and CUDA set-up included")

    tag = "ddp pretrain cli"
    r = res[tag]
    check(len(r["steps"]) == PRE_CLI_STEPS and r["step"] == r["count"] == PRE_CLI_STEPS,
          f"[{tag}] {len(r['steps'])} steps")
    for i, counts in enumerate(r["steps"]):
        check(counts == PER_STEP, f"[{tag}] step {i}: launches {counts} != {PER_STEP}")
    log, screen = check_cli_outputs(os.path.join(d, "ddp_device_aug"), tag)
    check("devices: 1 (cuda:0, nccl)" in screen, f"[{tag}] screen.txt names no NCCL group")
    s_it, s_data = epoch_rate(screen, PRE_CLI_EPOCHS - 1)
    with open(os.path.join(d, "device_aug", "screen.txt")) as f:
        one_it, one_data = epoch_rate(f.read(), PRE_CLI_EPOCHS - 1)
    print(f"[{tag}] run_pretrain --device_aug under torchrun, NCCL at world size 1, bf16 "
          f"batch {PRE_BATCH}, {PRE_CLI_EPOCHS} epochs of {PRE_CLI_STEPS // PRE_CLI_EPOCHS} "
          f"steps in {r['run']['seconds']:.3f} s; the last epoch {s_it * 1e3:.1f} ms a step "
          f"({PRE_BATCH / s_it:.1f} images/s, waiting {s_data * 1e3:.1f} ms for the loader) "
          f"against {one_it * 1e3:.1f} ms ({one_data * 1e3:.1f} waiting) in one process "
          f"([pretrain cli device_aug], this script), {(s_it - one_it) * 1e3:+.1f} ms by the "
          f"CLIs' own clocks; {collectives_text(r, PRE_CLI_STEPS)}; launches "
          f"{launches_text(r['steps'][0])} at every step; epoch losses "
          f"{[round(line['train_loss'], 5) for line in log]}")

    tag = "ddp pretrain cli resume argv"
    r = res[tag]
    for i, counts in enumerate(r["steps"]):
        check(counts == PER_STEP, f"[{tag}] step {i}: launches {counts} != {PER_STEP}")
    n, moments = check_bit_equal(torch, tag, r["run"], pre_ref)
    print(f"[{tag}] fp32 --device_aug under torchrun, NCCL at world size 1, against "
          f"[pretrain cli resume]'s straight run in this process: {n} tensors and {moments} "
          f"AdamW moment and step tensors equal bit for bit (torch.equal), log.txt byte for "
          f"byte; {r['run']['seconds']:.3f} s against {pre_ref['seconds']:.3f} s")

    tag = "ddp finetune cli"
    r = res[tag]
    n_steps = FT_CLI_RECORDS // FT_BATCH * FT_CLI_EPOCHS
    n_evals = -(-FT_CLI_EVAL_RECORDS // FT_BATCH) * FT_CLI_EPOCHS
    check(len(r["steps"]) == n_steps and len(r["evals"]) == n_evals and r["step"] == n_steps,
          f"[{tag}] {len(r['steps'])} steps, {len(r['evals'])} eval batches")
    for i, counts in enumerate(r["steps"]):
        check(counts == FT_PER_STEP, f"[{tag}] step {i}: launches {counts} != {FT_PER_STEP}")
    for i, counts in enumerate(r["evals"]):
        check(counts == FT_EVAL_BATCH, f"[{tag}] eval batch {i}: launches {counts}")
    out = os.path.join(d, "ddp_finetune")
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    check([line["epoch"] for line in log] == list(range(FT_CLI_EPOCHS))
          and all(math.isfinite(line["train_loss"]) and line["val_acc"] is not None
                  for line in log), f"[{tag}] log.txt {log}")
    with open(os.path.join(out, "screen.txt")) as f:
        screen = f.read()
    check("devices: 1 (cuda:0, nccl)" in screen, f"[{tag}] screen.txt names no NCCL group")
    check(f"{FT_CLI_EVAL_RECORDS} images, Acc" in screen, f"[{tag}] no eval line")
    s_it, s_data = epoch_rate(screen, FT_CLI_EPOCHS - 1)
    with open(os.path.join(d, "finetune_cli", "screen.txt")) as f:
        one_it, one_data = epoch_rate(f.read(), FT_CLI_EPOCHS - 1)
    print(f"[{tag}] run_finetune --dist_eval under torchrun, NCCL at world size 1, bf16 batch "
          f"{FT_BATCH}, {FT_CLI_EPOCHS} epochs of {n_steps // FT_CLI_EPOCHS} steps + eval of "
          f"{FT_CLI_EVAL_RECORDS} records after each in {r['run']['seconds']:.3f} s; the last "
          f"epoch {s_it * 1e3:.1f} ms a step (waiting {s_data * 1e3:.1f} ms for the loader) "
          f"against {one_it * 1e3:.1f} ms ({one_data * 1e3:.1f} waiting) in one process "
          f"([finetune cli]), {(s_it - one_it) * 1e3:+.1f} ms; {collectives_text(r, n_steps)}; "
          f"launches {launches_text(r['steps'][0])} at every step, "
          f"{launches_text(r['evals'][0])} every eval batch; val acc "
          f"{[line['val_acc'] for line in log]}")

    tag = "ddp finetune cli resume argv"
    r = res[tag]
    for i, counts in enumerate(r["steps"]):
        check(counts == FT_PER_STEP_RESUME, f"[{tag}] micro-step {i}: launches {counts}")
    check(r["step"] == n_steps and r["count"] == n_steps // 2,
          f"[{tag}] {r['step']} micro-steps, {r['count']} updates")
    n, moments = check_bit_equal(torch, tag, r["run"], ft_ref)
    print(f"[{tag}] fp32 --attn_drop_rate 0 --update_freq 2 --device_abi_aug under torchrun, "
          f"NCCL at world size 1, against [finetune cli resume]'s straight run: {n} tensors, "
          f"{moments} AdamW moment and step tensors and {len(ft_ref['acc'])} accumulators "
          f"equal bit for bit, log.txt byte for byte; {r['run']['seconds']:.3f} s against "
          f"{ft_ref['seconds']:.3f} s")
    return tuple(dict(zip(KERNEL_NAMES, (sum(c[k] for c in res[t]["steps"])
                                         for k in KERNEL_NAMES)))
                 for t in ("ddp pretrain cli", "ddp finetune cli"))


def phase_to_model_images(torch, np):
    """uint8 -> model input on the card against the CPU, all 256 values:
    both read the same table, built on the host with the JAX package's
    arithmetic."""
    from dig_tpu_torch.ops.images import to_model_images

    x = torch.arange(256, dtype=torch.uint8).reshape(1, 4, 64, 1)
    cpu, card = to_model_images(x), to_model_images(x.cuda()).cpu()
    differ = int((cpu.view(torch.int32) != card.view(torch.int32)).sum())
    check(differ == 0, f"[to_model_images] {differ} of 256 values differ between card and CPU")
    direct = ((x.cuda().float() / 255.0 - 0.5) / 0.5).cpu()
    off = int((direct.view(torch.int32) != cpu.view(torch.int32)).sum())
    print(f"[to_model_images] card vs CPU, all 256 uint8 values: {differ} differ (bit for bit); "
          f"the division computed on the card, as before the table: {off} of 256 one ulp off")


def write_labelled_lmdb(np, path, n, seed):
    """An LMDB of `n` seeded PNG word images with ``label-%09d`` words of
    1-25 characters of the charset (those of 24 or more are skipped by the
    dataset, as the reference skips them)."""
    from dig_tpu_torch.data.lmdb_store import LmdbWriter
    from dig_tpu_torch.utils.charset import build_charset

    charset = build_charset("ALLCASES_SYMBOLS", 25)
    rng = np.random.default_rng(seed)
    with LmdbWriter(path) as w:
        for i in range(1, n + 1):
            w.put(b"image-%09d" % i, encode_png(np, word_image(np, rng, i)))
            ids = rng.integers(0, charset.eos_id, rng.integers(1, 26))
            w.put(b"label-%09d" % i, "".join(charset.classes[j] for j in ids).encode())
        w.put(b"num-samples", str(n).encode())


@contextlib.contextmanager
def counted_calls(module, name, log, sync):
    """Wrap the factory `module.name` so that every call of the function it
    returns appends (launch counts of that call, seconds on the host clock)
    to `log`: with `sync`, to the end of its work on the card; without, to
    the end of its launches (the counts are the wrappers' host-side
    counters, so nothing waits for the card)."""
    import torch

    real = getattr(module, name)

    def factory(*a, **k):
        fn = real(*a, **k)

        def run(*args):
            before = read_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            if sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = read_counts()
            log.append(({n: after[n] - before[n] for n in after}, dt))
            return out
        return run

    setattr(module, name, factory)
    try:
        yield log
    finally:
        setattr(module, name, real)


# the fine-tuning CLI's step and eval-step factories, one of each per model kind
STEP_FACTORIES = ("make_finetune_step", "make_distill_finetune_step", "make_ctc_step",
                  "make_mim_finetune_step")
EVAL_FACTORIES = ("make_eval_step", "make_ctc_eval_step")


def run_finetune_cli(torch, tag, argv, cut_after_epoch=None):
    """`run_finetune.main` on `argv`, every step's and every eval batch's
    launches recorded (the step and eval-step factories wrapped; an eval
    batch is timed to its end on the card, which the CLI waits for anyway
    to score its ids; a step is not waited for); with `cut_after_epoch`,
    stopped by an exception from that epoch's log write.  Returns (state or results, step log, eval log,
    launch counts of the whole run, seconds)."""
    from dig_tpu_torch.cli import run_finetune
    from dig_tpu_torch.config import FinetuneConfig, parse_config

    class Cut(Exception):
        pass

    real_write = run_finetune.JsonlLogger.write

    def write(self, **stats):
        real_write(self, **stats)
        if stats["epoch"] == cut_after_epoch:
            raise Cut

    cfg = parse_config(FinetuneConfig, argv)
    stdout = sys.stdout
    steps, evals = [], []
    reset_counts()
    t0 = time.perf_counter()
    out = None
    with contextlib.ExitStack() as stack:
        for name in STEP_FACTORIES:
            stack.enter_context(counted_calls(run_finetune, name, steps, sync=False))
        for name in EVAL_FACTORIES:
            stack.enter_context(counted_calls(run_finetune, name, evals, sync=True))
        run_finetune.JsonlLogger.write = write
        try:
            out = run_finetune.main(cfg)
        except Cut:
            pass
        finally:
            run_finetune.JsonlLogger.write = real_write
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(sys.stdout is stdout, f"[{tag}] main left its tee on sys.stdout")
    check((out is None) == (cut_after_epoch is not None), f"[{tag}] the run was not cut")
    return out, steps, evals, read_counts(), dt


def check_each(tag, what, log, want):
    for i, (counts, _) in enumerate(log):
        check(counts == want, f"[{tag}] {what} {i}: launches {counts} != {want}")


def launches_text(counts):
    return str({k: v for k, v in counts.items() if v})


def phase_finetune_cli(torch, np, d, pre_ckpt, tag, extra_argv):
    """`run_finetune.main` as a user calls it: FinetuneConfig defaults (the
    full-width recognizer, bf16, batch 256, dropouts 0.1, 10 loader
    threads), the encoder from the pre-training CLI's checkpoint directory,
    2 epochs of 2 steps, eval on the eval LMDB after each."""
    from dig_tpu_torch.cli import run_finetune
    from dig_tpu_torch.config import FinetuneConfig, parse_config
    from dig_tpu_torch.utils.checkpoint import restore_checkpoint

    out = os.path.join(d, tag.replace(" ", "_"))
    argv = ["--data_path", os.path.join(d, "labelled"), "--eval_data_path",
            os.path.join(d, "labelled_eval"), "--finetune", pre_ckpt, "--output_dir", out,
            "--epochs", str(FT_CLI_EPOCHS), *extra_argv]
    cfg = parse_config(FinetuneConfig, argv)
    check(cfg.batch_size == FT_BATCH and cfg.dtype == "bfloat16" and cfg.num_workers == 10
          and cfg.use_abi_aug and cfg.model == "vit_small_patch4_32x128"
          and cfg.decoder_name == "tf_decoder" and cfg.attn_drop_rate == 0.1, f"config {cfg}")
    # the encoder right after the init, against the file
    inits = []
    real_init = run_finetune.load_finetune_init

    def init(c, model, *path):
        n = real_init(c, model, *path)
        inits.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                      if k.startswith("encoder.")})
        return n

    run_finetune.load_finetune_init = init
    try:
        state, steps, evals, counts, dt = run_finetune_cli(torch, tag, argv)
    finally:
        run_finetune.load_finetune_init = real_init
    saved = restore_checkpoint(pre_ckpt)["model"]
    check(len(inits) == 1 and inits[0], f"[{tag}] the encoder was not initialized")
    differ = [k for k, v in inits[0].items() if not torch.equal(v, saved[k])]
    check(not differ, f"[{tag}] {len(differ)} encoder tensors differ from the file: {differ[:4]}")
    n_steps = FT_CLI_RECORDS // FT_BATCH * FT_CLI_EPOCHS
    n_evals = -(-FT_CLI_EVAL_RECORDS // FT_BATCH) * FT_CLI_EPOCHS
    check(len(steps) == n_steps and len(evals) == n_evals,
          f"[{tag}] {len(steps)} steps, {len(evals)} eval batches; want {n_steps}, {n_evals}")
    check_each(tag, "step", steps, FT_PER_STEP)
    check_each(tag, "eval batch", evals, FT_EVAL_BATCH)
    check(state.step == state.optimizer.count == n_steps, f"[{tag}] {state.step} steps")
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    check([l["epoch"] for l in log] == list(range(FT_CLI_EPOCHS)), f"[{tag}] log.txt {log}")
    for l in log:
        check(math.isfinite(l["train_loss"]) and math.isfinite(l["train_grad_norm"])
              and l["val_acc"] is not None, f"[{tag}] log line {l}")
    for epoch in range(FT_CLI_EPOCHS):
        with open(os.path.join(out, f"checkpoint-{epoch}", "meta.json")) as f:
            meta = json.load(f)
        check(meta == {"step": (epoch + 1) * n_steps // FT_CLI_EPOCHS, "extra": {"epoch": epoch}},
              f"[{tag}] checkpoint-{epoch} meta {meta}")
    best = os.path.exists(os.path.join(out, "checkpoint-best", "meta.json"))
    check(best == (log[-1]["max_accuracy"] > 0),
          f"[{tag}] checkpoint-best {'written' if best else 'missing'} at max accuracy "
          f"{log[-1]['max_accuracy']}")
    with open(os.path.join(out, "screen.txt")) as f:
        screen = f.read()
    s_it, s_data = epoch_rate(screen, FT_CLI_EPOCHS - 1)
    eval_ms = [t * 1e3 for _, t in evals]
    step_ms = [t * 1e3 for _, t in steps]
    print(f"[{tag}] run_finetune.main {' '.join(extra_argv) or '(host ABI augmentation)'}, "
          f"--finetune the pre-training CLI's {os.path.basename(pre_ckpt)} ({len(inits[0])} "
          f"encoder tensors equal to the file's bit for bit), bf16 batch {FT_BATCH}, "
          f"{FT_CLI_EPOCHS} epochs of {n_steps // FT_CLI_EPOCHS} steps + eval of "
          f"{FT_CLI_EVAL_RECORDS} records after each, in {dt:.3f} s (model build, evals and "
          f"checkpoints included); the last epoch {s_it * 1e3:.1f} ms a step = "
          f"{FT_BATCH / s_it:.1f} images/s by the CLI's own clock, waiting {s_data * 1e3:.1f} ms "
          f"a step for the loader; the host queues a step in (median) "
          f"{sorted(step_ms)[len(step_ms) // 2]:.1f} ms; eval {statistics.mean(eval_ms):.1f} ms a "
          f"batch of {FT_BATCH} (greedy, full length); launches {launches_text(steps[0][0])} at "
          f"every step, {launches_text(evals[0][0])} every eval batch; epoch losses "
          f"{[round(l['train_loss'], 4) for l in log]}, val acc {[l['val_acc'] for l in log]}; "
          f"checkpoint-0, checkpoint-1{', checkpoint-best' if best else ''} written")
    del state
    torch.cuda.empty_cache()
    return counts, out


def phase_device_abi_aug(torch, np, d):
    """`device_abi_augment` on one loader batch of 256: card against CPU
    under one set of draws (the warp from one set of matrices at
    WARP_ATOL, the whole view at VIEW_ATOL on images as smooth as a word
    image), and its time on the card's clock."""
    from dig_tpu_torch.data import device_aug as aug
    from dig_tpu_torch.data.dataset import build_dataset
    from dig_tpu_torch.data.pipeline import make_train_loader
    from dig_tpu_torch.ops.images import to_model_images
    from dig_tpu_torch.utils.profiling import profile_fn
    from dig_tpu_torch.utils.rng import step_generator

    ds = build_dataset([os.path.join(d, "labelled")], is_train=True)
    loader = make_train_loader(ds, local_batch=FT_BATCH, rank=0, world=1, seed=0, num_workers=4)
    u8 = torch.from_numpy(next(iter(loader))[0])
    check(u8.shape == (FT_BATCH, 32, 128, 3) and u8.dtype == torch.uint8, f"batch {u8.shape}")
    x_cpu = to_model_images(u8)
    x = x_cpu.cuda()
    out = aug.device_abi_augment(step_generator(1, 1, 0, "cuda"), x)
    check(out.shape == x.shape and out.is_cuda and bool(torch.isfinite(out).all())
          and float(out.abs().max()) <= 1.0, "the ABI view is not a finite image in [-1, 1]")
    again = aug.device_abi_augment(step_generator(1, 1, 0, "cuda"), x)
    check(torch.equal(out, again), "one (seed, stream, step), two views")
    changed = int((out != x).flatten(1).any(1).sum())

    params = aug.draw_abi_augment_params(torch.Generator().manual_seed(0), FT_BATCH, 32, 128)
    every_op = dict(params, **{k: torch.ones_like(v) for k, v in params.items()
                               if k.endswith("_gate")})
    smooth = torch.from_numpy(np.repeat(np.repeat(np.random.default_rng(1).uniform(
        -1, 1, (FT_BATCH, 8, 32, 3)).astype(np.float32), 4, axis=1), 4, axis=2))
    errs = []
    for p in (params, every_op):  # the batch's own gates, then every op on every sample
        err = max_err(aug.device_abi_augment(None, smooth.cuda(), p).cpu(),
                      aug.device_abi_augment(None, smooth, p))
        check(err <= VIEW_ATOL, f"[device abi aug] view, card vs CPU: {err} > {VIEW_ATOL}")
        errs.append(err)
    h_mats = aug.perspective_h(params["persp_noise_h"], params["persp_noise_w"], 32, 128)
    werr = max_err(aug.batched_projective_warp(x, h_mats.cuda()).cpu(),
                   aug.batched_projective_warp(x_cpu, h_mats))
    check(werr <= WARP_ATOL, f"[device abi aug] the warp from one set of matrices: {werr}")
    steps = iter(range(1, 1000))
    ms = time_ms(lambda: aug.device_abi_augment(step_generator(1, 1, next(steps), "cuda"), x),
                 iters=20)
    _, busy_ms, wall_ms = profile_fn(lambda: aug.device_abi_augment(
        step_generator(1, 1, 0, "cuda"), x))
    print(f"[device abi aug] batch {FT_BATCH} of word images: {changed} views changed; card vs "
          f"CPU under one set of draws, fp32, on smooth images: max abs err {errs[0]:.3e} "
          f"(the batch's gates), {errs[1]:.3e} (every op on every sample; atol {VIEW_ATOL}); the "
          f"projective warp alone from one set of matrices, on the batch: {werr:.3e} (atol "
          f"{WARP_ATOL}); {ms:.3f} ms a batch (CUDA events, 20 batches); one profiled batch: "
          f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall")
    return ms


def phase_finetune_resume(torch, d, pre_ckpt, kind=()):
    """Resume equivalence of the fine-tuning CLI on the card: fp32,
    attention dropout 0 (the encoder's attention on the kernel pair #3 /
    #4), `--update_freq 2`, `--device_abi_aug`: two epochs straight (A)
    against one epoch, a fresh `main` that auto-resumes checkpoint-0, and
    the second epoch (B).  `kind`: more argv, a model kind's (`--model_kind
    ctc`, whose loss must repeat its bits too)."""
    tag = " ".join(["finetune cli resume", *kind])
    run_name = "_".join(["ft_resume", *(k.strip("-") for k in kind)])
    argv = lambda out: ["--data_path", os.path.join(d, "labelled"), "--finetune", pre_ckpt,
                        "--output_dir", os.path.join(d, out), "--epochs", str(FT_CLI_EPOCHS),
                        "--dtype", "float32", "--attn_drop_rate", "0", "--update_freq", "2",
                        "--device_abi_aug", *kind]
    a, steps_a, _, counts, dt_a = run_finetune_cli(torch, tag + " A", argv(run_name + "_a"))
    _, steps_b1, _, _, _ = run_finetune_cli(torch, tag + " B", argv(run_name + "_b"),
                                            cut_after_epoch=0)
    b, steps_b2, _, _, _ = run_finetune_cli(torch, tag + " B resumed", argv(run_name + "_b"))
    n_micro = FT_CLI_RECORDS // FT_BATCH * FT_CLI_EPOCHS
    check(len(steps_a) == len(steps_b1) + len(steps_b2) == n_micro,
          f"[{tag}] {len(steps_a)} / {len(steps_b1)} + {len(steps_b2)} micro-steps")
    for log in (steps_a, steps_b1, steps_b2):
        check_each(tag, "micro-step", log, FT_PER_STEP_RESUME)
    check(a.step == b.step == n_micro and a.optimizer.count == b.optimizer.count == n_micro // 2,
          f"[{tag}] steps {a.step} / {b.step}, updates {a.optimizer.count} / {b.optimizer.count}")
    with open(os.path.join(d, run_name + "_b", "screen.txt")) as f:
        check("auto-resumed from" in f.read(), f"[{tag}] B did not auto-resume")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    check(not differ, f"[{tag}] {len(differ)} of {len(sa)} tensors differ, e.g. {differ[:4]}")
    oa = a.optimizer.inner.state_dict()["state"]
    ob = b.optimizer.inner.state_dict()["state"]
    check(sorted(oa) == sorted(ob) and len(oa) > 0, f"[{tag}] AdamW states {len(oa)} vs {len(ob)}")
    moments = 0
    for i in oa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(oa[i][name], ob[i][name]), f"[{tag}] AdamW {name} of parameter {i}")
            moments += 1
    check(all(torch.equal(x, y) for x, y in zip(a.optimizer.acc, b.optimizer.acc))
          and a.optimizer.mini_step == b.optimizer.mini_step == 0, f"[{tag}] accumulators")
    with open(os.path.join(d, run_name + "_a", "log.txt")) as fa, \
            open(os.path.join(d, run_name + "_b", "log.txt")) as fb:
        check(fa.read() == fb.read(), f"[{tag}] the two runs' log.txt differ")
    print(f"[{tag}] fp32 --attn_drop_rate 0 --update_freq 2 --device_abi_aug {' '.join(kind)} "
          f"batch {FT_BATCH}: "
          f"{FT_CLI_EPOCHS} epochs straight ({n_micro} micro-steps, {n_micro // 2} updates, "
          f"{dt_a:.3f} s) vs 1 epoch + a fresh main auto-resuming checkpoint-0 + 1 epoch: "
          f"{len(sa)} tensors, {moments} AdamW moment and step tensors and "
          f"{len(a.optimizer.acc)} accumulators equal bit for bit (torch.equal); log.txt equal "
          f"byte for byte; launches {launches_text(steps_a[0][0])} at every micro-step")
    with open(os.path.join(d, run_name + "_a", "log.txt")) as f:
        ref = straight_run(a, f.read(), dt_a)
    del a, b
    torch.cuda.empty_cache()
    return counts, ref


def phase_finetune_eval_sweep(torch, np, d, ft_out):
    """`--eval` over the eval LMDB and a second one from the fine-tuning
    CLI's checkpoint (`--resume`), greedy and then `--beam_width 3`; beam
    width 1 against greedy on one batch; one beam batch timed; and
    `torch.cuda.set_sync_debug_mode("warn")` around one beam batch."""
    import warnings

    from dig_tpu_torch.cli import run_finetune
    from dig_tpu_torch.config import FinetuneConfig, parse_config
    from dig_tpu_torch.train.finetune import make_eval_step
    from dig_tpu_torch.utils.charset import build_charset

    tag = "finetune eval sweep"
    second = os.path.join(d, "labelled_eval2")
    write_labelled_lmdb(np, second, FT_CLI_EVAL2_RECORDS, 9)
    sets = [(os.path.join(d, "labelled_eval"), FT_CLI_EVAL_RECORDS),
            (second, FT_CLI_EVAL2_RECORDS)]
    ckpt = os.path.join(ft_out, f"checkpoint-{FT_CLI_EPOCHS - 1}")
    counts_all = per_step()
    results = {}
    for beam in (0, 3):
        out = os.path.join(d, f"sweep_beam{beam}")
        argv = ["--eval", "--resume", ckpt, "--eval_data_path", sets[0][0],
                "--other_test_data_folders", sets[1][0], "--beam_width", str(beam),
                "--output_dir", out]
        res, _, evals, counts, dt = run_finetune_cli(torch, f"{tag} beam {beam}", argv)
        n_batches = sum(-(-n // FT_BATCH) for _, n in sets)
        check(len(evals) == n_batches, f"[{tag}] {len(evals)} eval batches, want {n_batches}")
        check_each(tag, "eval batch", evals, FT_EVAL_BATCH)
        with open(os.path.join(out, "eval_results.json")) as f:
            saved = json.load(f)
        check([r["n"] for r in saved["benchmarks"]] == [n for _, n in sets]
              and saved["n_images"] == sum(n for _, n in sets) and saved["beam_width"] == beam,
              f"[{tag}] eval_results.json {saved}")
        results[beam] = (saved, statistics.mean(t for _, t in evals) * 1e3, dt)
        counts_all = {k: counts_all[k] + counts[k] for k in counts}

    # beam width 1 against greedy on one batch: the ids up to each row's first EOS
    cfg = parse_config(FinetuneConfig, ["--resume", ckpt])
    model = run_finetune.build_model(cfg, "cuda")
    from dig_tpu_torch.utils.checkpoint import restore_checkpoint

    model.load_state_dict(restore_checkpoint(ckpt)["model"])
    charset = build_charset(cfg.voc_type, cfg.max_len)
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (FT_BATCH, 32, 128, 3), dtype=np.uint8)).cuda()
    batch = {"images": images, "targets": torch.zeros((FT_BATCH, 25), dtype=torch.long,
                                                      device="cuda"),
             "lengths": torch.ones((FT_BATCH,), dtype=torch.long, device="cuda")}
    greedy, _ = make_eval_step(model)(batch)
    beam1, loss1 = make_eval_step(model, 1, charset.eos_id)(batch)
    greedy, beam1 = greedy.cpu().numpy(), beam1.cpu().numpy()
    mismatch = 0
    for g, b in zip(greedy, beam1):
        stop = list(g).index(charset.eos_id) + 1 if charset.eos_id in g else len(g)
        mismatch += int(not np.array_equal(g[:stop], b[:stop]))
    check(mismatch == 0 and float(loss1.abs().max()) == 0.0,
          f"[{tag}] beam width 1 differs from greedy in {mismatch} of {FT_BATCH} rows")
    beam_step = make_eval_step(model, 3, charset.eos_id)
    beam_ms = time_ms(lambda: beam_step(batch), iters=3, warmup=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            beam_step(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sync_sites(caught)
    (g_res, g_ms, g_dt), (b_res, b_ms, b_dt) = results[0], results[3]
    print(f"[{tag}] --eval --resume checkpoint-{FT_CLI_EPOCHS - 1} over "
          f"{' + '.join(str(n) for _, n in sets)} records (batch {FT_BATCH}, the last of each "
          f"padded): greedy acc {[round(r['acc'], 4) for r in g_res['benchmarks']]} in "
          f"{g_dt:.3f} s ({g_ms:.1f} ms an eval batch), beam 3 acc "
          f"{[round(r['acc'], 4) for r in b_res['benchmarks']]} in {b_dt:.3f} s ({b_ms:.1f} ms "
          f"an eval batch); eval_results.json n = {[r['n'] for r in b_res['benchmarks']]}; beam "
          f"width 1 equals greedy up to each row's first EOS in all {FT_BATCH} rows; a beam-3 "
          f"batch {beam_ms:.1f} ms (CUDA events); launches {launches_text(FT_EVAL_BATCH)} every "
          f"eval batch, greedy and beam; set_sync_debug_mode('warn') over one beam-3 batch: "
          f"{sum(syncs.values())} synchronisations {dict(syncs)}")
    del model
    torch.cuda.empty_cache()
    return counts_all


@contextlib.contextmanager
def eval_ids(log):
    """Wrap `run_finetune.make_eval_step` so that the ids of every eval
    batch it returns are appended to `log`, on the host."""
    from dig_tpu_torch.cli import run_finetune

    real = run_finetune.make_eval_step

    def factory(*a, **k):
        fn = real(*a, **k)

        def run(batch):
            out = fn(batch)
            log.append(out[0].cpu())
            return out
        return run

    run_finetune.make_eval_step = factory
    try:
        yield log
    finally:
        run_finetune.make_eval_step = real


def eval_run_ids(torch, d, tag, source_argv):
    """`run_finetune.main --eval` on the eval LMDB with `source_argv` (the
    weights' flags): the ids of its eval batches, concatenated."""
    ids = []
    argv = ["--eval", "--eval_data_path", os.path.join(d, "labelled_eval"), "--output_dir",
            os.path.join(d, "export", tag.replace(" ", "_")), *source_argv]
    with eval_ids(ids):
        _, _, evals, _, _ = run_finetune_cli(torch, f"export pth {tag}", argv)
    check_each(f"export pth {tag}", "eval batch", evals, FT_EVAL_BATCH)
    return torch.cat(ids)


def phase_export_pth(torch, d, pre_ckpt, ft_out):
    """`python -m dig_tpu_torch.tools.export_pth` as a user runs it, on the
    pre-training CLI's last checkpoint (`--encoder_only`, and `--encoder_only
    --ema`) and on the fine-tuning CLI's: the tensors against the
    checkpoint's, then each .pth fed back through `run_finetune --finetune`
    (and the recognizer's through `run_predict --finetune`), its ids against
    those of the source checkpoint (tanh GELU kept with `--exact_gelu
    false`: the source runs trained under it)."""
    from dig_tpu_torch.cli.run_predict import main as predict_main
    from dig_tpu_torch.config import parse_config
    from dig_tpu_torch.tools import export_pth
    from dig_tpu_torch.utils.checkpoint import _write_checkpoint, restore_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(d, "export")
    os.makedirs(root, exist_ok=True)
    pths = {name: os.path.join(root, f"{name}.pth") for name in ("encoder", "ema", "recognizer")}
    t0 = time.perf_counter()
    export_pth.main([pre_ckpt, pths["encoder"], "--encoder_only"])
    export_pth.main([pre_ckpt, pths["ema"], "--encoder_only", "--ema"])
    ft_ckpt = os.path.join(ft_out, f"checkpoint-{FT_CLI_EPOCHS - 1}")
    export_pth.main([ft_ckpt, pths["recognizer"]])
    export_s = time.perf_counter() - t0
    pre, ft = restore_checkpoint(pre_ckpt)["model"], restore_checkpoint(ft_ckpt)["model"]
    wants = {"encoder": {k: v for k, v in pre.items() if k.startswith("encoder.")},
             "ema": {k[len("momentum_"):]: v for k, v in pre.items()
                     if k.startswith("momentum_encoder.")},
             "recognizer": ft}
    sizes = {}
    for name, want in wants.items():
        got = torch.load(pths[name], weights_only=True)["model"]
        check(sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want),
              f"[export pth] {name}.pth: {len(got)} tensors, not the checkpoint's {len(want)}")
        sizes[name] = len(got)
    # the momentum encoder as a directory's encoder: the source the --ema .pth is held to
    momentum_dir = os.path.join(root, "momentum_as_encoder")
    _write_checkpoint(momentum_dir, {"model": wants["ema"], "step": 0}, None)
    tanh = ["--exact_gelu", "false"]
    pairs = {"encoder": (["--finetune", pre_ckpt], ["--finetune", pths["encoder"], *tanh]),
             "ema": (["--finetune", momentum_dir], ["--finetune", pths["ema"], *tanh]),
             "recognizer": (["--resume", ft_ckpt], ["--finetune", pths["recognizer"], *tanh])}
    rows = {}
    for name, (source, exported) in pairs.items():
        a = eval_run_ids(torch, d, f"{name} source", source)
        b = eval_run_ids(torch, d, f"{name} pth", exported)
        check(torch.equal(a, b), f"[export pth] {name}: the .pth's eval ids differ from the "
              f"source's in {int((a != b).any(1).sum())} of {len(a)} rows")
        rows[name] = len(a)
    tsvs = []
    for flags in (["--resume", ft_ckpt], ["--finetune", pths["recognizer"], *tanh]):
        tsv = os.path.join(root, f"predict{len(tsvs)}.tsv")
        predict_main(parse_config(argv=["--data_path", os.path.join(d, "labelled_eval"),
                                        "--output", tsv, *flags]))
        with open(tsv) as f:
            tsvs.append(f.read())
    check(tsvs[0] == tsvs[1] and tsvs[0].count("\n") == FT_CLI_EVAL_RECORDS,
          "[export pth] run_predict --finetune of the .pth differs from --resume of its source")
    print(f"[export pth] dig_tpu_torch.tools.export_pth: the pre-training CLI's "
          f"{os.path.basename(pre_ckpt)} --encoder_only ({sizes['encoder']} tensors) and "
          f"--encoder_only --ema ({sizes['ema']}), the fine-tuning CLI's "
          f"checkpoint-{FT_CLI_EPOCHS - 1} ({sizes['recognizer']}) in {export_s:.2f} s, each "
          f"tensor equal to the checkpoint's; run_finetune --eval --finetune <.pth> "
          f"--exact_gelu false: the ids of {rows} eval rows equal to the source's (--finetune "
          f"the pre-training directory, a directory of its momentum encoder, --resume the "
          f"fine-tuning checkpoint); run_predict --finetune <recognizer .pth>: the TSV of "
          f"{FT_CLI_EVAL_RECORDS} records equal to --resume's; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")


def sync_sites(caught):
    """{file:line of the Python call: count} of the host waits that
    `torch.cuda.set_sync_debug_mode("warn")` reported in `caught`."""
    import collections

    return collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
                               if "called a synchronizing" in str(w.message))


def phase_sync_debug_step(torch, np):
    """`torch.cuda.set_sync_debug_mode("warn")` around one fine-tuning step
    at the FinetuneConfig defaults: every host wait it finds."""
    import warnings

    model, state, step, batch_np, _ = finetune_setup(torch, np, torch.bfloat16, FT_BATCH, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, batch, gen)  # warm-up
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state, batch, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sync_sites(caught)
    print(f"[sync debug] set_sync_debug_mode('warn') over one fine-tuning step (bf16 batch "
          f"{FT_BATCH}): {sum(syncs.values())} synchronisations {dict(syncs)}")
    del model, state, batch
    torch.cuda.empty_cache()


def phase_process_workers_under_cuda(np, d):
    """A process-worker loader started from this process, which has CUDA
    initialised and runs threads: abandoned half-way, then started again
    and read to its end.  A watchdog fails the run after PROCESS_WATCHDOG_S."""
    import threading

    from dig_tpu_torch.data.dataset import build_pretraining_dataset
    from dig_tpu_torch.data.pipeline import make_train_loader, stop_worker_processes

    ds = build_pretraining_dataset([os.path.join(d, "words")], num_view=2,
                                   rng=np.random.default_rng(0))
    loader = make_train_loader(ds, local_batch=PRE_BATCH, rank=0, world=1, seed=0,
                               num_workers=8, worker_type="process")
    result = {}

    def run():
        t0 = time.perf_counter()
        for i, _ in enumerate(loader):
            if i == len(loader) // 2 - 1:
                break
        result["abandon_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["n"] = sum(len(b[0]) for b in loader)
        result["epoch_s"] = time.perf_counter() - t0

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(PROCESS_WATCHDOG_S)
    if worker.is_alive():  # hung: no result line, and no wait on the stuck pool at exit
        print(f"chip_smoke: FAILED: [process workers under CUDA] no end after "
              f"{PROCESS_WATCHDOG_S} s", file=sys.stderr, flush=True)
        for proc in child_processes():  # the stuck pool may hold the forkserver's lock
            with contextlib.suppress(OSError):
                os.kill(int(proc.split()[0]), 9)
        os._exit(1)
    check(result.get("n") == PRE_CLI_RECORDS, f"[process workers under CUDA] {result}")
    t0 = time.perf_counter()
    terminated = stop_worker_processes()
    check(not terminated, f"[process workers under CUDA] workers still alive after 30 s: {terminated}")
    check(not child_processes(), f"[process workers under CUDA] processes left: {child_processes()}")
    result["stop_s"] = time.perf_counter() - t0
    rate = PRE_CLI_RECORDS / result["epoch_s"]
    print(f"[process workers under CUDA] 8 forkserver workers started from this process (CUDA "
          f"initialised): an epoch abandoned after {len(loader) // 2} of {len(loader)} batches "
          f"({result['abandon_s']:.2f} s, pool start included), then a whole epoch of "
          f"{result['n']} images with host SeqCLR augmentation in {result['epoch_s']:.2f} s = "
          f"{rate:.1f} images/s; watchdog {PROCESS_WATCHDOG_S} s; workers, forkserver and "
          f"resource tracker stopped in {result['stop_s']:.2f} s, no child process left")
    return rate


def child_processes():
    """["pid args"] of every live process descended from this one, read
    from /proc: the script must leave none when it ends."""
    parent, args = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # ended while we read
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z":  # a zombie has ended: only its exit status is left
            parent[int(entry)], args[int(entry)] = int(fields[1]), cmd[:120]
    found, todo = [], [os.getpid()]
    while todo:
        pid = todo.pop()
        kids = [p for p, pp in parent.items() if pp == pid]
        found += [f"{p} {args[p]}" for p in kids]
        todo += kids
    return found


def stop_children(wait_s=10.0):
    """Stop what the port's process workers started and wait up to
    `wait_s` for any other child; kill what is still alive then, and
    return its list (empty when everything had ended)."""
    try:
        from dig_tpu_torch.data.pipeline import stop_worker_processes

        stop_worker_processes(timeout=wait_s)
    except ImportError:
        pass
    deadline = time.monotonic() + wait_s
    while child_processes() and time.monotonic() < deadline:
        time.sleep(0.1)
    left = child_processes()
    for proc in left:
        with contextlib.suppress(OSError):
            os.kill(int(proc.split()[0]), 9)
    return left


def phase_cpu_parity(torch, np):
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.ops.images import to_model_images

    kw = dict(dtype=torch.float32, seed=1)
    m_cpu = build_rec_model("vit_small_patch4_32x128", "tf_decoder", 97, 25, device="cpu", **kw)
    m_gpu = build_rec_model("vit_small_patch4_32x128", "tf_decoder", 97, 25, device="cuda", **kw)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (8, 32, 128, 3), dtype=np.uint8))
    reset_counts()
    with torch.no_grad():
        f_cpu = m_cpu.encoder(to_model_images(x))
        f_gpu = m_gpu.encoder(to_model_images(x.cuda())).cpu()
        check(read_counts() == per_step(attention_lse_fwd=12, layer_norm_fwd=24),
              f"the fp32 card path's launches {read_counts()}")
        p_cpu, ids_cpu = m_cpu.recognize(to_model_images(x))
        p_gpu, ids_gpu = m_gpu.recognize(to_model_images(x.cuda()))
    scale = float(f_cpu.abs().max())
    ferr = float((f_cpu - f_gpu).abs().max())
    check(ferr <= FEAT_RTOL * scale, f"encoder features differ by {ferr} (max |f| {scale})")
    top2 = p_cpu.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    ids_cpu, ids_gpu = ids_cpu.numpy(), ids_gpu.cpu().numpy()
    compared = 0
    for r in range(ids_cpu.shape[0]):
        for t in range(ids_cpu.shape[1]):
            if ids_cpu[r, t] != ids_gpu[r, t]:
                # a near-tie may flip; later steps then see another prefix
                check(margin[r, t] <= MARGIN_TOL,
                      f"greedy id differs at row {r} step {t} with margin {margin[r, t]}")
                break
            compared += 1
    print(f"[cpu parity] fp32, 8 images: encoder max abs diff {ferr:.3e} (max |f| {scale:.3e}, "
          f"rtol {FEAT_RTOL}); {compared}/{ids_cpu.size} greedy ids compared equal")


def rel_err(got, ref):
    """max |got - ref| over max |ref|."""
    return max_err(got, ref) / max(float(ref.float().abs().max()), 1e-30)


def repeats(torch, first, call):
    """Whether a second call, `call(out)` into NaN-filled gradients `out`,
    gives the first call's bits: the backward kernels use no atomics and
    write every element."""
    out = tuple(torch.full_like(t, math.nan) for t in first)
    call(out)
    return all(bool(torch.equal(a, b)) for a, b in zip(first, out))


def phase_attention_bwd(torch, attn, gen):
    rows = {}
    scale = D**-0.5
    b = PRE_B
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        qkv = torch.randn(b, L, 3 * C, generator=gen, device="cuda").to(dt)
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(b, L, H, D) for i in range(3))
        do = torch.randn(b, L, H, D, generator=gen, device="cuda").to(dt)
        _, m, s = attn.attention_lse_fwd(q, k, v, scale)
        # the gradient lands in the column slices of one packed [B, L, 3C]
        # tensor, as the ViT's backward takes it
        dqkv = torch.empty_like(qkv)
        out = tuple(dqkv[..., i * C:(i + 1) * C].view(b, L, H, D) for i in range(3))
        attn.attention_lse_bwd(q, k, v, do, m, s, scale, out=out)
        torch.cuda.synchronize()
        ref = attn.attention_lse_bwd_ref(q, k, v, do, m, s, scale)
        errs = {}
        for name, got, r in zip(("dq", "dk", "dv"), out, ref):
            check(bool(torch.isfinite(got.float()).all()), f"attention_lse_bwd {dn} {name} not finite")
            errs[name] = max_err(got, r)
            rel = rel_err(got, r)
            check(rel <= BWD_RTOL[dn], f"attention_lse_bwd {dn} {name}: max abs err "
                                       f"{errs[name]} = {rel:.2e} of max |ref| > {BWD_RTOL[dn]}")
        del ref
        check(repeats(torch, out,
                      lambda o: attn.attention_lse_bwd(q, k, v, do, m, s, scale, out=o)),
              f"attention_lse_bwd {dn}: a second call gave other bits")
        ms = time_ms(lambda: attn.attention_lse_bwd(q, k, v, do, m, s, scale, out=out), iters=5)
        plain_ms = time_ms(lambda: attn.attention_lse_bwd_ref(q, k, v, do, m, s, scale),
                           iters=2, warmup=1)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
                         iters=5)
        isz = qkv.element_size()
        nbytes = 7 * b * L * C * isz + 2 * b * L * H * 4  # q, k, v, do in; dq, dk, dv out; m, s in
        bms, by = bound(nbytes, 10 * b * H * L * L * D, dn)
        rows[dn] = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, library_ms=lib_ms)
        print(f"[attention_lse_bwd {dn}] B={b} L={L} H={H} D={D}: max_abs_err "
              f"dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e}, a second call equal "
              f"bit for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.3f} of the bound"
              f"{fma_body_text('attention_lse_bwd', dn)}")
        del qkv, q, k, v, do, m, s, dqkv, out, qt, kt, vt, o, dot
        torch.cuda.empty_cache()
    return rows


def check_layernorm_bwd(torch, ln, tag, x, g, dy, eps):
    """The kernel against its plain version (dx at TOL, dgamma and dbeta
    within BWD_RTOL["float32"] of the largest), and two calls bit for bit
    equal: (dx max abs err, dgamma / dbeta max abs err)."""
    dn = str(x.dtype).split(".")[1]
    got = ln.layer_norm_bwd(x, g, dy, eps)
    again = ln.layer_norm_bwd(x, g, dy, eps)
    torch.cuda.synchronize()
    ref = ln._ln_bwd_ref(x, g, dy, eps)
    err = check_close(f"{tag} dx", got[0], ref[0], TOL[dn])
    for name, a, r in (("dgamma", got[1], ref[1]), ("dbeta", got[2], ref[2])):
        rel = rel_err(a, r)
        check(rel <= BWD_RTOL["float32"], f"{tag} {name}: {rel:.2e} of max |ref|")
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, again):
        check(torch.equal(a, b), f"{tag} {name}: two calls on the same inputs differ")
    return err, max(max_err(got[1], ref[1]), max_err(got[2], ref[2]))


STRESS_CALLS = 2000  # launches of #4 and of #2 at each shape of [attention_bwd stress]


def phase_attention_bwd_stress(torch, attn, gen):
    """#4 and #2 in bf16, STRESS_CALLS launches each at the pre-training
    shapes, at the seq-cls encoder's (L = 281, H = 12) and on one tensor
    rank's heads (H = 3), through `stress` of tools/time_attention_bwd.py:
    the packed gradient and the scratch between the passes NaN-filled before
    every launch, half the launches beside GEMMs on a second stream, each
    launch's bits compared with the first's.  Fails on any launch that
    differs.  Returns {kernel name: (calls, differing calls)}; these
    launches are not counted on any path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "time_attention_bwd", os.path.join(ROOT, "tools", "time_attention_bwd.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    totals = {"attention_lse_bwd": [0, 0], "attention_bwd": [0, 0]}
    for tag, b, l, h in (("pretrain", PRE_B, L, H), ("seq-cls", FT_BATCH, SEQ_CLS_L, 12),
                         ("tensor split", PRE_B, L, H // 2)):
        for name, (calls, n_diff) in tool.stress(attn, (b, l, h, D), STRESS_CALLS, gen,
                                                 f"attention_bwd {tag}").items():
            totals[name][0] += calls
            totals[name][1] += n_diff
        torch.cuda.empty_cache()
    print("[attention_bwd stress] " + "; ".join(
        f"{name}: {calls} calls, {n_diff} differing from their shape's first call"
        for name, (calls, n_diff) in totals.items()))
    for name, (_, n_diff) in totals.items():
        check(n_diff == 0, f"attention_bwd stress: {n_diff} launches of {name} gave other bits")
    return {name: tuple(v) for name, v in totals.items()}


def phase_layernorm_bwd(torch, ln, gen):
    rows = {}
    eps = 1e-6
    r = PRE_B * L
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for er, ec in LN_BWD_EDGE_SHAPES:
            ex = (2 * torch.randn(er, ec, generator=gen, device="cuda") + 0.5).to(dt)
            edy = torch.randn(er, ec, generator=gen, device="cuda").to(dt)
            eg = 1.0 + 0.1 * torch.randn(ec, generator=gen, device="cuda")
            e_err, e_gerr = check_layernorm_bwd(torch, ln, f"layer_norm_bwd {dn} {er}x{ec}",
                                                ex, eg, edy, eps)
            print(f"[layer_norm_bwd {dn}] rows={er} c={ec}: max_abs_err dx={e_err:.3e} "
                  f"dgamma,dbeta={e_gerr:.3e}; two calls equal bit for bit")
        x = (2 * torch.randn(r, C, generator=gen, device="cuda") + 0.5).to(dt)
        dy = torch.randn(r, C, generator=gen, device="cuda").to(dt)
        g = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        err, gerr = check_layernorm_bwd(torch, ln, f"layer_norm_bwd {dn}", x, g, dy, eps)
        # five timings of 200 launches each: one reading of 50 launches was
        # once 2.6x the others on an unchanged kernel; the median is kept
        reps = sorted(time_ms(lambda: ln.layer_norm_bwd(x, g, dy, eps), iters=200)
                      for _ in range(5))
        ms = reps[2]
        plain_ms = time_ms(lambda: ln._ln_bwd_ref(x, g, dy, eps), iters=5)
        xl = x.detach().requires_grad_()
        gl = g.to(dt).requires_grad_()
        bl = torch.zeros(C, device="cuda", dtype=dt, requires_grad=True)
        y = torch.nn.functional.layer_norm(xl, (C,), gl, bl, eps)
        lib_ms = time_ms(lambda: torch.autograd.grad(y, (xl, gl, bl), dy, retain_graph=True),
                         iters=50)
        nbytes = 3 * r * C * x.element_size() + 3 * C * 4  # x, dy in, dx out; gamma in, dgamma, dbeta out
        bms, by = bound(nbytes, 16 * r * C, "float32")
        rows[dn] = dict(max_abs_err=max(err, gerr), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, library_ms=lib_ms)
        old = (f"; the first body took {LN_BWD_FIRST_BODY_MS:.4f} ms (PERF.md)"
               if dt == torch.bfloat16 else "")
        print(f"[layer_norm_bwd {dn}] rows={r} c={C}: max_abs_err dx={err:.3e} "
              f"dgamma,dbeta={gerr:.3e}; two calls equal bit for bit; kernel {ms:.4f} ms "
              f"(median of 5 x 200 launches: {[round(t, 4) for t in reps]}), "
              f"plain {plain_ms:.4f} ms, F.layer_norm backward {lib_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}), {bms / ms:.3f} of the bound{old}")
        del x, dy, xl, y
        torch.cuda.empty_cache()
    return rows


def shard_for(model, mesh):
    """Shard `model` on `mesh` as the CLIs do (`shard_model`, before the
    optimizer is built), keeping on it the bytes its parameters and AdamW's
    two moments take a rank by the rules' placements (`param_shardings`
    of the whole model): the share the rules predict."""
    from dig_tpu_torch.parallel.mesh import param_shardings
    from dig_tpu_torch.parallel.sharding import shard_model

    sizes = {None: 1, "fsdp": mesh.n_fsdp, "tensor": mesh.n_tensor}
    named = dict(model.named_parameters())
    params = moments = 0
    for name, pl in param_shardings(model, mesh.n_fsdp, mesh.n_tensor).items():
        p = named[name]
        n = p.numel() // sizes[pl.mesh_axis] * p.element_size()
        params += n
        moments += 2 * n if p.requires_grad else 0
    shard_model(model, mesh)
    model.predicted_bytes = (params, moments)


def pretrain_setup(torch, np, dtype, batch, device, seed=0, start_step=0, mesh=None,
                   **model_kw):
    """The port's pre-training entry points as a user calls them: the
    model, AdamW and the step, with the schedules built as
    `dig_tpu/cli/run_pretrain.py:98-110` builds them from the
    `PretrainConfig` defaults (first lr = warmup_lr > 0), the state's step
    counter at `start_step`, and one batch of uint8 views with exact-count
    masks from numpy seed `seed`.  `model_kw` overrides the model's
    arguments (remat, patchnet_name, drop_path_rate, encoder_depth).  With
    `mesh`, the model is sharded on it before the optimizer is built."""
    from dig_tpu_torch.config import PretrainConfig
    from dig_tpu_torch.models.moco import build_pretrain_model
    from dig_tpu_torch.optim import create_optimizer
    from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
    from dig_tpu_torch.utils.schedules import (
        contrast_weight_schedule, cosine_schedule, moco_momentum_schedule)

    cfg = PretrainConfig(batch_size=batch).finalize(1)
    steps_per_epoch = 1000
    lr = cosine_schedule(cfg.absolute_lr, cfg.min_lr, cfg.epochs, steps_per_epoch,
                         warmup_epochs=cfg.warmup_epochs, start_warmup_value=cfg.warmup_lr,
                         warmup_steps=cfg.warmup_steps)
    wd = cosine_schedule(cfg.weight_decay, cfg.weight_decay_end, cfg.epochs, steps_per_epoch)
    mom = moco_momentum_schedule(cfg.moco_m, cfg.epochs, steps_per_epoch, cfg.use_moco_m_cos)
    cw = contrast_weight_schedule(cfg.loss_weight_contrast, cfg.epochs, steps_per_epoch,
                                  cfg.contrast_start_epoch, cfg.contrast_warmup_steps)
    check(lr[0] > 0, "the first step's lr must be above 0")
    model_kw = dict(dict(patchnet_name=cfg.patchnet_name, remat=cfg.remat), **model_kw)
    model = build_pretrain_model(cfg.model, dtype=dtype, seed=seed, device=device,
                                 mlp_dim=cfg.moco_mlp_dim, dim=cfg.moco_dim,
                                 temperature=cfg.moco_t, num_windows=cfg.num_windows,
                                 label_smoothing=cfg.label_smoothing, **model_kw)
    if mesh is not None:
        shard_for(model, mesh)
    opt = create_optimizer(cfg.opt, model.named_parameters(), lr, wd, betas=cfg.opt_betas,
                           eps=cfg.opt_eps, clip_grad=cfg.clip_grad)
    state = init_pretrain_state(model, opt)
    state.step = opt.count = start_step
    step = make_pretrain_step(model, mom, cw, loss_weight_pixel=cfg.loss_weight_pixel,
                              only_mim_on_ori_img=cfg.only_mim_on_ori_img,
                              normalize_target=cfg.normlize_target)
    rng = np.random.default_rng(seed)
    n = model.num_patches
    mask = np.zeros((batch, 2, n), bool)
    for r in range(batch):
        for v in range(2):
            mask[r, v, rng.permutation(n)[:PRE_MASKED]] = True
    batch_np = {"images": rng.integers(0, 256, (batch, 32, 128, 3), dtype=np.uint8),
                "aug_images": rng.integers(0, 256, (batch, 32, 128, 3), dtype=np.uint8),
                "mask": mask}
    return model, state, step, batch_np


def reset_counts():
    from dig_tpu_torch.ops import kernel_wrappers

    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    from dig_tpu_torch.ops import launch_counts

    return launch_counts()


@contextlib.contextmanager
def switches(store_lse=True, fused_bias_grad=False, bf16_exp=False):
    """The JAX package's opt-in switches, as a user sets them: the two
    environment variables the port reads at every call, and `BF16_EXP`,
    which it reads at import."""
    from dig_tpu_torch.ops import attention

    env = {"DIG_TPU_ATTN_STORE_LSE": "1" if store_lse else "0",
           "DIG_TPU_FUSED_BIAS_GRAD": "1" if fused_bias_grad else "0"}
    saved = {k: os.environ.get(k) for k in env}
    saved_exp = attention.BF16_EXP
    os.environ.update(env)
    attention.BF16_EXP = bf16_exp
    try:
        yield
    finally:
        attention.BF16_EXP = saved_exp
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed_steps(torch, run_step, n):
    """n steps with CUDA events between them (each step on the card's
    timeline, no host wait) and the host clock around all of them, ended by
    a synchronise.  Returns (the steps' results, host seconds, per-step ms)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    out = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n):
        out.append(run_step())
        events[i + 1].record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def step_times_text(step_times):
    srt = sorted(step_times)
    return (f"median {srt[len(srt) // 2]:.2f} ms, min {srt[0]:.2f}, max {srt[-1]:.2f}, "
            f"in order {[round(t, 2) for t in step_times]}")


def check_counts(tag, counts, want, steps):
    for name, n in want.items():
        check(counts[name] == n * steps,
              f"{tag} {name}: {counts[name]} launches in {steps} steps, want {n} a step")


def check_trained(torch, model, before, tag):
    """Every trainable tensor has a finite gradient, and every tensor of
    `before` moved from it."""
    missing = [n for n, p in model.named_parameters()
               if p.requires_grad and (p.grad is None or not torch.isfinite(p.grad).all())]
    check(not missing, f"{tag}: parameters without a finite gradient: {missing[:8]}")
    params = dict(model.named_parameters())
    moved = [n for n, b in before.items() if not torch.equal(params[n].detach(), b)]
    check(len(moved) == len(before), f"{tag}: {len(before) - len(moved)} parameters did not move")
    return len(moved)


def print_profile(torch, tag, fn):
    from dig_tpu_torch.utils.profiling import profile_fn

    top, busy_ms, wall_ms = profile_fn(fn)
    for name, ms in top:
        print(f"[profile {tag}] {ms:9.3f} ms  {name[:100]}")
    print(f"[profile {tag}] one step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")


def phase_pretrain(torch, np, tag, want, measure=True):
    """The bf16 step at PRE_BATCH: launches, losses and moved tensors
    checked; with `measure`, its time on the host's and the card's clock
    and one profiled step printed."""
    model, state, step, batch_np = pretrain_setup(torch, np, torch.bfloat16, PRE_BATCH, "cuda")
    # the batch moves to the card once, as a prefetching loader would hand it over
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PRE_WARMUP):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    student = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    momentum = {n: p.detach().clone() for n, p in model.named_parameters()
                if not p.requires_grad}

    reset_counts()
    results, dt, step_times = timed_steps(torch, lambda: step(state, batch), PRE_STEPS)
    counts = read_counts()
    check_counts(f"[{tag}]", counts, want, PRE_STEPS)
    state, metrics = results[-1]
    losses = torch.stack([m["loss"] for _, m in results]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}")
    moved = check_trained(torch, model, student, f"[{tag}] student")
    ema_moved = [n for n, p in model.named_parameters() if not p.requires_grad
                 and not torch.equal(p.detach(), momentum[n])]
    check(len(ema_moved) == len(momentum),
          f"{len(momentum) - len(ema_moved)} momentum parameters did not move")
    timing = (f"{PRE_STEPS} steps in {dt:.3f} s = {dt / PRE_STEPS * 1e3:.2f} ms/step, "
              f"{PRE_BATCH * PRE_STEPS / dt:.1f} images/s on this card (per step on the card's "
              f"clock: {step_times_text(step_times)})" if measure
              else f"{PRE_STEPS} steps, untimed")
    last = {k: round(float(v), 5) for k, v in metrics.items()}
    print(f"[{tag}] pretrain_simmim_moco_ori_vit_small_patch4_32x128 bf16 batch {PRE_BATCH} "
          f"({n_params / 1e6:.2f} M student params): {timing}; launches per step "
          f"{ {k: v // PRE_STEPS for k, v in counts.items()} }; losses "
          f"{[round(x, 5) for x in losses.tolist()]}; last metrics {last}; "
          f"{moved} student and {len(ema_moved)} momentum tensors moved; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if measure:
        print_profile(torch, tag, lambda: step(state, batch))
    del model, state, batch, student, momentum, results
    torch.cuda.empty_cache()
    return counts


def leaf_parity(tag, loss_cpu, loss_gpu, g_cpu, g_gpu):
    """Loss and every gradient leaf, card vs CPU, within STEP_RTOL of the
    leaf's max |g| plus STEP_FLOOR of the largest gradient."""
    check(abs(loss_cpu - loss_gpu) <= STEP_RTOL * abs(loss_cpu),
          f"{tag}: loss {loss_gpu} on the card vs {loss_cpu}")
    floor = STEP_FLOOR * max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for name, g in g_cpu.items():
        err = float((g_gpu[name] - g).abs().max())
        scale = float(g.abs().max())
        check(err <= STEP_RTOL * scale + floor,
              f"{tag}: gradient {name}: card vs CPU max abs err {err} (max |g| {scale})")
        if err / max(scale, 1e-30) > worst and scale > floor:
            worst, worst_name = err / scale, name
    return worst, worst_name


def phase_pretrain_cpu_parity(torch, np, tag, want):
    """One fp32 step of the full-width model at batch 2, card vs CPU, from
    identical weights, schedules and inputs; at the step where the
    contrast weight has ramped up (0 at step 0), so both losses reach
    every gradient."""
    runs = {}
    for device in ("cpu", "cuda"):
        model, state, step, batch_np = pretrain_setup(torch, np, torch.float32, 2, device, seed=1,
                                                      start_step=500)
        reset_counts()
        state, metrics = step(state, batch_np)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts == want, f"{tag}: the fp32 card step's launches {counts} != {want}")
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.requires_grad}
        runs[device] = (float(metrics["loss"]), grads)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    worst, worst_name = leaf_parity(tag, l_cpu, l_gpu, g_cpu, g_gpu)
    print(f"[{tag}] fp32 batch 2, full width: loss {l_gpu:.7f} (card) vs "
          f"{l_cpu:.7f} (cpu); {len(g_cpu)} gradient leaves within {STEP_RTOL} of their max "
          f"|g|; worst {worst:.2e} ({worst_name}); kernels launched "
          f"{ {k: v for k, v in want.items() if v} }")


def phase_attention_recompute(torch, attn, gen):
    """#1 at the pretrain shapes, both branches, against its plain
    version; without BF16_EXP its output must equal the stored-statistics
    forward's bit for bit (one kernel body)."""
    rows = {}
    scale = D**-0.5
    b = PRE_B
    for dt, bf16_exp in ((torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)):
        dn = str(dt).split(".")[1]
        key = dn + ("_bf16_exp" if bf16_exp else "")
        qkv = torch.randn(b, L, 3 * C, generator=gen, device="cuda").to(dt)
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(b, L, H, D) for i in range(3))
        with switches(store_lse=False, bf16_exp=bf16_exp):
            o = attn.attention_fwd(q, k, v, scale)
            torch.cuda.synchronize()
            ro = attn.attention_fwd_ref(q, k, v, scale)
            err, flips = check_fwd_o(f"attention_fwd {key} o", o, ro, dn, bf16_exp)
            ms = time_ms(lambda: attn.attention_fwd(q, k, v, scale))
            plain_ms = time_ms(lambda: attn.attention_fwd_ref(q, k, v, scale), iters=3)
        same = bool(torch.equal(o, attn.attention_lse_fwd(q, k, v, scale)[0]))
        check(same or bf16_exp, f"attention_fwd {key}: o differs from attention_lse_fwd's o")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
        nbytes = 4 * b * L * C * qkv.element_size()  # q, k, v in; o out
        bms, by = bound(nbytes, 4 * b * H * L * L * D, dn)
        rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms)
        print(f"[attention_fwd {key}] B={b} L={L} H={H} D={D}: max_abs_err o={err:.3e}"
              f"{flips}; "
              f"bitwise equal to attention_lse_fwd's o: {same}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{bms / ms:.3f} of the bound{fma_body_text('attention_fwd', key)}")
        del qkv, q, k, v, o, ro, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_attention_bwd_recompute(torch, attn, gen):
    """#2 at the pretrain shapes against its plain version, timed beside
    SDPA's backward; it must equal #4 on the same inputs bit for bit, in
    both dtypes: its row (bf16) or dq (fp32) pass takes m and s from the
    forward's logits, in the forward's order."""
    rows = {}
    scale = D**-0.5
    b = PRE_B
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        qkv = torch.randn(b, L, 3 * C, generator=gen, device="cuda").to(dt)
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(b, L, H, D) for i in range(3))
        do = torch.randn(b, L, H, D, generator=gen, device="cuda").to(dt)
        dqkv = torch.empty_like(qkv)
        out = tuple(dqkv[..., i * C:(i + 1) * C].view(b, L, H, D) for i in range(3))
        attn.attention_bwd(q, k, v, do, scale, out=out)
        torch.cuda.synchronize()
        ref = attn.attention_bwd_ref(q, k, v, do, scale)
        errs = {}
        for name, got, r in zip(("dq", "dk", "dv"), out, ref):
            check(bool(torch.isfinite(got.float()).all()), f"attention_bwd {dn} {name} not finite")
            errs[name] = max_err(got, r)
            rel = rel_err(got, r)
            check(rel <= BWD_RTOL[dn], f"attention_bwd {dn} {name}: max abs err "
                                       f"{errs[name]} = {rel:.2e} of max |ref| > {BWD_RTOL[dn]}")
        del ref
        _, m, s = attn.attention_lse_fwd(q, k, v, scale)
        lse = attn.attention_lse_bwd(q, k, v, do, m, s, scale)
        same = all(bool(torch.equal(a, c)) for a, c in zip(out, lse))
        to_lse = max(rel_err(a, c) for a, c in zip(out, lse))
        check(same, f"attention_bwd {dn}: not bitwise equal to attention_lse_bwd "
                    f"({to_lse:.2e} of max |grad| apart)")
        check(repeats(torch, out, lambda o: attn.attention_bwd(q, k, v, do, scale, out=o)),
              f"attention_bwd {dn}: a second call gave other bits")
        del lse, m, s
        ms = time_ms(lambda: attn.attention_bwd(q, k, v, do, scale, out=out), iters=5)
        plain_ms = time_ms(lambda: attn.attention_bwd_ref(q, k, v, do, scale), iters=2, warmup=1)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
                         iters=5)
        nbytes = 7 * b * L * C * qkv.element_size()  # q, k, v, do in; dq, dk, dv out
        bms, by = bound(nbytes, 10 * b * H * L * L * D, dn)
        rows[dn] = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, library_ms=lib_ms)
        print(f"[attention_bwd {dn}] B={b} L={L} H={H} D={D}: max_abs_err "
              f"dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e}; bitwise equal to "
              f"attention_lse_bwd: {same}, a second call equal bit for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"backward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.3f} of the bound"
              f"{fma_body_text('attention_bwd', dn)}")
        del qkv, q, k, v, do, dqkv, out, qt, kt, vt, o, dot
        torch.cuda.empty_cache()
    return rows


def phase_colsum(torch, fd, gen):
    """#7 on fc1's bias gradient shape, bf16, and at a ragged row count,
    against its plain version and `sum(0, dtype=float32)` (the library
    call); the bound is bytes: N * C * 2 read, C * 4 written."""
    rows = {}
    for n in (FC1_ROWS, FC1_ROWS + 300):
        x = torch.randn(n, FC1_COLS, generator=gen, device="cuda").to(torch.bfloat16)
        got = fd.column_sum(x)
        torch.cuda.synchronize()
        ref = fd.column_sum_ref(x)
        lib = x.sum(0, dtype=torch.float32)
        rel = rel_err(got, ref)
        check(rel <= COLSUM_RTOL, f"column_sum N={n}: {rel:.2e} of max |ref| from the plain version")
        check(rel_err(got, lib) <= COLSUM_RTOL, f"column_sum N={n}: off the library call")
        check(bool(torch.equal(got, fd.column_sum(x))), f"column_sum N={n} changed between runs")
        ms = time_ms(lambda: fd.column_sum(x), iters=50)
        plain_ms = time_ms(lambda: fd.column_sum_ref(x), iters=20)
        lib_ms = time_ms(lambda: x.sum(0, dtype=torch.float32), iters=50)
        bms, by = bound(n * FC1_COLS * 2 + FC1_COLS * 4, n * FC1_COLS, "float32")
        rows[n] = dict(max_abs_err=max_err(got, ref), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms)
        print(f"[column_sum bfloat16] N={n} C={FC1_COLS}: max_abs_err {rows[n]['max_abs_err']:.3e} "
              f"({rel:.2e} of max |sum|), the same bits every run; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sum(0, dtype=float32) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del x
    return rows[FC1_ROWS]


def finetune_setup(torch, np, dtype, batch, device, rates=True, seed=0, mesh=None):
    """`kind_setup` of the recognizer at the FinetuneConfig defaults:
    (model, state, step, batch, charset)."""
    _, model, state, step, batch_np, charset, _ = kind_setup(torch, np, {}, dtype, batch, device,
                                                             rates, seed, mesh)
    return model, state, step, batch_np, charset


def phase_finetune(torch, np, tag, want, profile=True):
    model, state, step, batch_np, _ = finetune_setup(torch, np, torch.bfloat16, FT_BATCH, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FT_WARMUP):
        state, metrics, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    reset_counts()
    results, dt, step_times = timed_steps(torch, lambda: step(state, batch, gen), FT_STEPS)
    counts = read_counts()
    check_counts(f"[{tag}]", counts, want, FT_STEPS)
    losses = torch.stack([m["loss"] for _, m, _ in results]).float().cpu()
    norms = torch.stack([m["grad_norm"] for _, m, _ in results]).float().cpu()
    check(bool(torch.isfinite(losses).all() and torch.isfinite(norms).all()),
          f"non-finite loss or grad norm: {losses.tolist()} {norms.tolist()}")
    ids = results[-1][2]
    check(ids.shape == (FT_BATCH, 25), f"pred ids {tuple(ids.shape)}")
    moved = check_trained(torch, model, before, f"[{tag}]")
    step_ms = dt / FT_STEPS * 1e3
    print(f"[{tag}] vit_small_patch4_32x128 + tf_decoder bf16 batch {FT_BATCH} "
          f"({n_params / 1e6:.2f} M params), dropout 0.1 / attention dropout 0.1 / drop-path "
          f"0.1, smoothing 0.1: {FT_STEPS} steps in {dt:.3f} s = {step_ms:.2f} ms/step, "
          f"{FT_BATCH * FT_STEPS / dt:.1f} images/s on this card (per step on the card's clock: "
          f"{step_times_text(step_times)}); launches per step "
          f"{ {k: v // FT_STEPS for k, v in counts.items()} }; losses "
          f"{[round(x, 4) for x in losses.tolist()]}; grad norms "
          f"{[round(x, 3) for x in norms.tolist()]}; {moved} tensors moved; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        print_profile(torch, tag, lambda: step(state, batch, gen))
    del model, state, batch, before, results
    torch.cuda.empty_cache()
    return counts


def phase_eval(torch, np, tag, want):
    from dig_tpu_torch.metrics.text import accuracy
    from dig_tpu_torch.train.finetune import make_eval_step

    model, _, _, batch_np, charset = finetune_setup(torch, np, torch.bfloat16, FT_BATCH, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    eval_step = make_eval_step(model)
    eval_step(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, loss = eval_step(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(counts == want, f"[{tag}] launches {counts} != {want}")
    check(ids.shape == (FT_BATCH, 25) and loss.shape == (FT_BATCH,), "eval shapes")
    check(bool(torch.isfinite(loss).all() and (loss >= 0).all()), "eval losses not finite")
    acc = accuracy(ids.cpu().numpy(), batch_np["targets"], charset)
    print(f"[{tag}] greedy, full length, batch {FT_BATCH}: {dt * 1e3:.2f} ms; mean row loss "
          f"{float(loss.mean()):.4f}; accuracy {acc:.4f} (random weights); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    del model, batch
    torch.cuda.empty_cache()
    return counts


def phase_finetune_cpu_parity(torch, np):
    """One fp32 fine-tuning step of the full-width recognizer at batch 4,
    all rates 0, the column sum on, card vs CPU.  4 x 256 encoder rows
    reach the column sum's 1,024-row gate and the kernel pairs' gates; the
    card's sums run in other orders (cuBLAS vs the CPU's BLAS, the kernels
    vs the plain versions) through 12 encoder and 6 decoder layers and a
    97-way softmax: within 1e-4 of each leaf's max |g|, as the pre-training
    check holds its leaves."""
    runs = {}
    with switches(fused_bias_grad=True):
        for device in ("cpu", "cuda"):
            model, state, step, batch_np, _ = finetune_setup(torch, np, torch.float32, 4, device,
                                                             rates=False, seed=1)
            reset_counts()
            state, metrics, _ = step(state, batch_np, torch.Generator(device=device).manual_seed(0))
            if device == "cuda":
                torch.cuda.synchronize()
                counts = read_counts()
                check(counts == FT_PER_STEP_RATES0,
                      f"the fp32 card fine-tuning step's launches {counts} != {FT_PER_STEP_RATES0}")
            grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            runs[device] = (float(metrics["loss"]), grads)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    worst, worst_name = leaf_parity("[finetune cpu parity]", l_cpu, l_gpu, g_cpu, g_gpu)
    print(f"[finetune cpu parity] fp32 batch 4, full width, rates 0: loss {l_gpu:.7f} (card) vs "
          f"{l_cpu:.7f} (cpu); {len(g_cpu)} gradient leaves within {STEP_RTOL} of their max "
          f"|g|; worst {worst:.2e} ({worst_name}); kernels launched "
          f"{ {k: v for k, v in FT_PER_STEP_RATES0.items() if v} }")


# ---------------------------------------------------------------------------
# every recognizer kind
# ---------------------------------------------------------------------------

KINDS_WARMUP, KINDS_STEPS = 2, 5
SEQ_CLS_MODEL = "vit_seq_cls_base_patch4_32x128"
# vit_seq_cls_base: 25 class queries + 256 patches.  Its LayerNorms see
# B x 281 rows, a multiple of the LayerNorm kernel's 512-row blocks only at
# B = 512k (281 is prime), so they take the plain version, as the JAX
# package's gate (rows % 512) sends them; its attention takes #3 / #4
SEQ_CLS_L = 281
# launches a step at FinetuneConfig defaults (attention dropout 0.1: the
# student's attention is unfused) and an eval batch, per kind
KIND_STEP_DISTILL = per_step(attention_lse_fwd=12, layer_norm_fwd=48, layer_norm_bwd=24)
SEQ_CLS_STEP = per_step()
SEQ_CLS_STEP_ATTN0 = per_step(attention_lse_fwd=12, attention_lse_bwd=12)
SEQ_CLS_EVAL = per_step(attention_lse_fwd=12)
# rates 0 (the card-vs-CPU check): the encoder's attention on the stored-statistics pair
KIND_STEP_RATES0 = FT_PER_STEP_RESUME
# name -> (FinetuneConfig fields, beam widths of its eval, launches a step, an eval batch;
# at rates 0 a step)
KINDS = {
    "ctc": (dict(model_kind="ctc"), (0,), FT_PER_STEP, FT_EVAL_BATCH, KIND_STEP_RATES0),
    "attn": (dict(model_kind="attn"), (0, 3), FT_PER_STEP, FT_EVAL_BATCH, KIND_STEP_RATES0),
    "mim_rec": (dict(model_kind="mim_rec"), (0,), FT_PER_STEP, FT_EVAL_BATCH, KIND_STEP_RATES0),
    "decoupled": (dict(decoder_name="decoupled_tf_decoder"), (0, 3), FT_PER_STEP, FT_EVAL_BATCH,
                  KIND_STEP_RATES0),
    "text_cond": (dict(text_cond_vis=True), (0,), FT_PER_STEP, FT_EVAL_BATCH, KIND_STEP_RATES0),
    "distill": (dict(use_feat_distill=True), (0,), KIND_STEP_DISTILL, FT_EVAL_BATCH,
                dict(KIND_STEP_DISTILL, attention_lse_fwd=24, attention_lse_bwd=12)),
    "seq_cls": (dict(model=SEQ_CLS_MODEL, model_kind="seq_cls"), (0,), SEQ_CLS_STEP,
                SEQ_CLS_EVAL, SEQ_CLS_STEP_ATTN0),
    "seq_cls attn_drop 0": (dict(model=SEQ_CLS_MODEL, model_kind="seq_cls", attn_drop_rate=0.0),
                            (0,), SEQ_CLS_STEP_ATTN0, SEQ_CLS_EVAL, SEQ_CLS_STEP_ATTN0),
}
# trainable tensors a kind's training loss does not reach, in both packages:
# the multi-label head's presence layer (the reference trains the recognition
# CE only; its logits serve the eval's F-measure); its weight still decays
KIND_IDLE = {"decoupled": {"multi_label.presence.bias"}}
# the distillation projector's gradients pass three batch-statistics norms
# over B x L rows, whose backward cancels the gradient's part along the
# normalized features: fp32 puts them up to 1.1e-2 of a leaf's max from the
# fp64 value (tests/test_torch_port_kinds_steps.py), so card and CPU are
# held at 2e-2 there
FEAT_PROJ_RTOL = 2e-2


def labelled_batch(np, charset, max_len, batch, seed):
    """Random words of 1-24 characters, then EOS, then PADDING, over uint8 noise."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, max_len + 1, batch)  # characters + EOS
    targets = np.full((batch, max_len), charset.padding_id, np.int64)
    for i, n in enumerate(lengths):
        targets[i, :n - 1] = rng.integers(0, charset.eos_id, n - 1)
        targets[i, n - 1] = charset.eos_id
    return {"images": rng.integers(0, 256, (batch, 32, 128, 3), dtype=np.uint8),
            "targets": targets, "lengths": lengths}


def kind_setup(torch, np, fields, dtype, batch, device, rates=True, seed=0, mesh=None):
    """The port's fine-tuning entry points as a user calls them: the
    recognizer, step and eval of the FinetuneConfig defaults with `fields`
    (a kind's), built as the fine-tuning CLI builds them
    (`run_finetune.build_model` / `make_step`); AdamW with the schedules
    built as `dig_tpu/cli/run_finetune.py:311-330` builds them (1000 steps an
    epoch, so the first lr, in the warm-up, is above 0); one batch of uint8
    images with labels from numpy seed `seed` (`labelled_batch`).  The
    distillation teacher is a second recognizer from the same seed, frozen.
    `rates=False`: every rate 0, the decoders' too (the card-vs-CPU checks).
    With `mesh`, the model is sharded on it before the optimizer is built.
    Returns (cfg, model, state, step, batch, charset, teacher or None)."""
    from dig_tpu_torch.cli import run_finetune
    from dig_tpu_torch.config import FinetuneConfig
    from dig_tpu_torch.optim import create_optimizer, frozen_encoder_mask
    from dig_tpu_torch.train.finetune import init_finetune_state, make_distill_finetune_step
    from dig_tpu_torch.utils.charset import build_charset
    from dig_tpu_torch.utils.schedules import cosine_schedule

    fields = dict(fields, batch_size=batch, seed=seed,
                  dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    if not rates:
        fields.update(drop=0.0, attn_drop_rate=0.0, drop_path=0.0)
    cfg = FinetuneConfig(**fields).finalize(1)
    lr = cosine_schedule(cfg.absolute_lr, cfg.min_lr, cfg.epochs, 1000,
                         warmup_epochs=cfg.warmup_epochs, start_warmup_value=cfg.warmup_lr,
                         warmup_steps=cfg.warmup_steps)
    wd = cosine_schedule(cfg.weight_decay, cfg.weight_decay_end, cfg.epochs, 1000)
    check(lr[0] > 0, "the first step's lr must be above 0")
    charset = build_charset(cfg.voc_type, cfg.max_len)
    check(charset.num_classes == cfg.nb_classes, "charset and nb_classes disagree")

    def build(**kw):
        model = run_finetune.build_model(cfg, device, **kw)
        if not rates:  # the modules read their rate at every call
            for m in model.modules():
                if hasattr(m, "dropout") and isinstance(m.dropout, float):
                    m.dropout = 0.0
        return model

    model = build()
    if mesh is not None:
        shard_for(model, mesh)
    frozen = (frozen_encoder_mask(cfg.fixed_encoder_layers) if cfg.fixed_encoder_layers > 0
              else None)
    opt = create_optimizer(cfg.opt, model.named_parameters(), lr, wd, betas=cfg.opt_betas,
                           eps=cfg.opt_eps, clip_grad=cfg.clip_grad, layer_decay=cfg.layer_decay,
                           num_layers=model.encoder.depth, frozen=frozen,
                           update_freq=cfg.update_freq)
    state = init_finetune_state(model, opt)
    teacher = None
    if cfg.use_feat_distill:
        teacher = build(use_feat_distill=False).requires_grad_(False)
        step = make_distill_finetune_step(model, teacher, cfg.smoothing,
                                          cfg.loss_weight_feat_distill)
    else:
        step = run_finetune.make_step(cfg, model, device)
    return cfg, model, state, step, labelled_batch(np, charset, cfg.max_len, batch, seed), \
        charset, teacher


def kind_eval(torch, cfg, model, charset, beam):
    """The CLI's eval step for the kind, at beam width `beam`."""
    import dataclasses

    from dig_tpu_torch.cli import run_finetune

    return run_finetune.make_eval(dataclasses.replace(cfg, beam_width=beam), model, charset)[0]


def run_kind_step(torch, np, name, batch_size):
    """`name`'s step at `batch_size`: warm-up, timed steps, checks; then its
    eval batches.  Returns (launch counts of the timed steps, the text)."""
    tag = f"kinds step {name}"
    _, beams, want, want_eval, _ = KINDS[name]
    cfg, model, state, step, batch_np, charset, teacher = kind_setup(
        torch, np, KINDS[name][0], torch.bfloat16, batch_size, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(KINDS_WARMUP):
        state, metrics, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    idle = KIND_IDLE.get(name, set())
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad and n not in idle}
    t_before = None if teacher is None else {k: v.clone() for k, v in teacher.state_dict().items()}
    reset_counts()
    results, dt, step_times = timed_steps(torch, lambda: step(state, batch, gen), KINDS_STEPS)
    counts = read_counts()
    check_counts(f"[{tag}]", counts, want, KINDS_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack([m["loss"] for _, m, _ in results]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"[{tag}] non-finite loss: {losses.tolist()}")
    moved = check_trained(torch, model, before, f"[{tag}]")
    if teacher is not None:
        changed = [k for k, v in teacher.state_dict().items() if not torch.equal(v, t_before[k])]
        check(not changed, f"[{tag}] the teacher moved: {changed[:4]}")
    evals = []
    for beam in beams:
        eval_fn = kind_eval(torch, cfg, model, charset, beam)
        eval_fn(batch)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = eval_fn(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ev = read_counts()
        check(ev == want_eval, f"[{tag}] eval beam {beam} launches {ev} != {want_eval}")
        ids, loss = out[0], out[1]
        check(ids.shape[0] == batch_size and loss.shape == (batch_size,)
              and bool(torch.isfinite(loss).all()), f"[{tag}] eval beam {beam} outputs")
        evals.append(f"{'greedy' if beam == 0 else f'beam {beam}'} {ms:.1f} ms")
    srt = sorted(step_times)
    text = (f"bf16 batch {batch_size}: {srt[len(srt) // 2]:.2f} ms a step (median of "
            f"{KINDS_STEPS} on the card's clock; {dt / KINDS_STEPS * 1e3:.2f} ms by the host's), "
            f"eval batch {', '.join(evals)}; peak memory {peak:.2f} GiB; launches a step "
            f"{launches_text({k: v // KINDS_STEPS for k, v in counts.items()})}, an eval batch "
            f"{launches_text(want_eval)}; losses {[round(x, 4) for x in losses.tolist()]}; "
            f"{moved} tensors moved"
            + (f", {sorted(idle)} outside the loss" if idle else "")
            + (", the teacher unchanged" if teacher is not None else ""))
    return counts, text


def phase_kinds_step(torch, np, paths):
    """Each kind's fine-tuning step at full width and the FinetuneConfig
    defaults, bf16, batch 256 (the largest half of it that fits in the
    card's memory where 256 does not), and its eval batches."""
    import gc

    for name in KINDS:
        batch_size = FT_BATCH
        while True:
            try:
                counts, text = run_kind_step(torch, np, name, batch_size)
                break
            except torch.cuda.OutOfMemoryError as e:
                msg = str(e).splitlines()[0]
            gc.collect()
            torch.cuda.empty_cache()
            check(batch_size > 32, f"[kinds step {name}] does not fit even at batch {batch_size}")
            print(f"[kinds step {name}] batch {batch_size} does not fit in the card's memory "
                  f"({msg[:160]}); trying {batch_size // 2}")
            batch_size //= 2
        print(f"[kinds step {name}] {text}")
        paths["kinds_step_" + name.replace(" ", "_")] = counts
        gc.collect()
        torch.cuda.empty_cache()


def phase_memory_bank(torch, np):
    """The encoder's frozen memory bank (`num_mem_slots`, which no CLI flag
    sets): the recognizer at the FinetuneConfig defaults with 8 bank tokens
    in its encoder (264 tokens a row through the blocks), one bf16 step at
    batch 256; the bank takes no gradient and does not move, the rest does."""
    from dig_tpu_torch.models.rec_model import init_weights
    from dig_tpu_torch.models.registry import create_model
    from dig_tpu_torch.optim import create_optimizer

    cfg, model, state, step, batch_np, _, _ = kind_setup(torch, np, {}, torch.bfloat16, FT_BATCH,
                                                         "cuda")
    encoder = create_model(cfg.model, num_mem_slots=8, drop_rate=cfg.drop,
                           attn_drop_rate=cfg.attn_drop_rate, drop_path_rate=cfg.drop_path,
                           dtype=torch.bfloat16)
    init_weights(encoder, torch.Generator().manual_seed(3))
    model.encoder = encoder.cuda()
    state.optimizer = create_optimizer("adamw", model.named_parameters(), [1e-4], [0.05])
    bank = model.encoder.mem_bank.detach().clone()
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    reset_counts()
    state, metrics, _ = step(state, batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == FT_PER_STEP, f"[memory bank] launches {counts} != {FT_PER_STEP}")
    check(math.isfinite(float(metrics["loss"])), f"[memory bank] loss {metrics['loss']}")
    check(model.encoder.mem_bank.grad is None and torch.equal(model.encoder.mem_bank, bank),
          "[memory bank] the bank took a gradient or moved")
    moved = check_trained(torch, model, before, "[memory bank]")
    print(f"[memory bank] vit_small with 8 bank tokens + tf_decoder, bf16 batch {FT_BATCH}: one "
          f"step, the bank without a gradient and bit-equal after it, {moved} tensors moved; "
          f"launches {launches_text(counts)}")
    del model, state, batch
    torch.cuda.empty_cache()


def phase_kinds_cpu_parity(torch, np):
    """One fp32 step and one greedy eval batch of each kind at full width,
    batch 2, every rate 0, on the card against the same on the CPU: the
    loss and every gradient leaf within STEP_RTOL of its max |g| (plus the
    floor; the distillation projector at FEAT_PROJ_RTOL), the ids equal.
    The MIM step's masks are one set on both devices (its generator's
    draws differ between them)."""
    from dig_tpu_torch.data import masking

    mask = np.zeros((1, 1, 256), bool)
    mask[0, 0, np.random.default_rng(11).permutation(256)[:179]] = True
    real_mask = masking.random_mask_batch
    masking.random_mask_batch = lambda gen, b, n, k, v=1: torch.from_numpy(mask[:b]).to(gen.device)
    lines = []
    try:
        for name in KINDS:
            if name == "seq_cls attn_drop 0":  # at rates 0 the same model as seq_cls
                continue
            runs = {}
            for device in ("cpu", "cuda"):
                cfg, model, state, step, batch_np, charset, _ = kind_setup(
                    torch, np, KINDS[name][0], torch.float32, 2, device, rates=False, seed=1)
                reset_counts()
                state, metrics, _ = step(state, batch_np, torch.Generator(device=device).manual_seed(0))
                counts = read_counts()
                ids = kind_eval(torch, cfg, model, charset, 0)(batch_np)[0]
                if device == "cuda":
                    torch.cuda.synchronize()
                    want = KINDS[name][4]
                    check(counts == want, f"[kinds cpu parity {name}] launches {counts} != {want}")
                grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                         for n, p in model.named_parameters() if p.requires_grad}
                runs[device] = (float(metrics["loss"]), grads, ids.cpu().numpy())
            (l_cpu, g_cpu, i_cpu), (l_gpu, g_gpu, i_gpu) = runs["cpu"], runs["cuda"]
            proj = {k for k in g_cpu if k.startswith("feat_proj.")}
            worst, worst_name = leaf_parity(f"[kinds cpu parity {name}]", l_cpu, l_gpu,
                                            {k: v for k, v in g_cpu.items() if k not in proj},
                                            g_gpu)
            for k in sorted(proj):
                err, scale = float((g_gpu[k] - g_cpu[k]).abs().max()), float(g_cpu[k].abs().max())
                check(err <= FEAT_PROJ_RTOL * scale + 1e-12,
                      f"[kinds cpu parity {name}] {k}: {err} of max |g| {scale}")
            check(np.array_equal(i_cpu, i_gpu), f"[kinds cpu parity {name}] greedy ids differ: "
                                                f"{int((i_cpu != i_gpu).sum())} of {i_cpu.size}")
            lines.append(f"{name}: loss {l_gpu:.6f} vs {l_cpu:.6f}, {len(g_cpu)} leaves, worst "
                         f"{worst:.1e} ({worst_name}), ids equal")
    finally:
        masking.random_mask_batch = real_mask
    print(f"[kinds cpu parity] fp32 batch 2, full width, rates 0, card vs CPU: "
          + "; ".join(lines))


def phase_attention_l281(torch, attn, gen):
    """#3, #4, #1 and #2 at the seq-cls encoder's shape (B = 256, L = 281:
    25 class queries + 256 patches, not a multiple of the 64-row blocks;
    H = 12, D = 64) against their plain versions, bf16 and fp32, at the
    tolerances of the pre-training shapes; each timed beside SDPA's."""
    return phase_attention_at(torch, attn, gen, f"attention at L={SEQ_CLS_L}", FT_BATCH,
                              SEQ_CLS_L, 12)


def phase_attention_at(torch, attn, gen, tag, b, l, h):
    """#3, #4, #1 and #2 on q, k, v read as column slices of one packed
    [B, L, 3 H D] projection (D = 64), against their plain versions, bf16
    and fp32, each timed beside SDPA's; returns {dtype: times}."""
    d = 64
    c = h * d
    rows = {}
    scale = d**-0.5
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        qkv = torch.randn(b, l, 3 * c, generator=gen, device="cuda").to(dt)
        q, k, v = (qkv[..., i * c:(i + 1) * c].view(b, l, h, d) for i in range(3))
        do = torch.randn(b, l, h, d, generator=gen, device="cuda").to(dt)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                          iters=5)
        o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do.transpose(1, 2),
                                                          retain_graph=True), iters=5)
        del o_lib, qt, kt, vt
        io = 4 * b * l * c * qkv.element_size()
        fwd_bound, fwd_by = bound(io + 2 * b * l * h * 4, 4 * b * h * l * l * d, dn)
        bwd_bound, bwd_by = bound(7 * b * l * c * qkv.element_size() + 2 * b * l * h * 4,
                                  10 * b * h * l * l * d, dn)
        # #3 stored-statistics forward
        o, m, s = attn.attention_lse_fwd(q, k, v, scale)
        ro, rm, rs = attn.attention_lse_fwd_ref(q, k, v, scale)
        err3, flips = check_fwd_o(f"attention_lse_fwd L={l} {dn} o", o, ro, dn)
        check_close(f"attention_lse_fwd L={l} {dn} m", m, rm, STAT_TOL)
        check_close(f"attention_lse_fwd L={l} {dn} s", s, rs, STAT_TOL)
        ms3 = time_ms(lambda: attn.attention_lse_fwd(q, k, v, scale), iters=5)
        plain3 = time_ms(lambda: attn.attention_lse_fwd_ref(q, k, v, scale), iters=2, warmup=1)
        del ro, rm, rs
        # #4 backward from m, s; #2 recompute backward, equal to #4 bit for bit
        dqkv = torch.empty_like(qkv)
        out = tuple(dqkv[..., i * c:(i + 1) * c].view(b, l, h, d) for i in range(3))
        attn.attention_lse_bwd(q, k, v, do, m, s, scale, out=out)
        ref = attn.attention_lse_bwd_ref(q, k, v, do, m, s, scale)
        rel4 = max(rel_err(g, r) for g, r in zip(out, ref))
        check(all(bool(torch.isfinite(g.float()).all()) for g in out) and rel4 <= BWD_RTOL[dn],
              f"attention_lse_bwd L={l} {dn}: {rel4:.2e} of max |ref| > {BWD_RTOL[dn]}")
        del ref
        check(repeats(torch, out,
                      lambda o: attn.attention_lse_bwd(q, k, v, do, m, s, scale, out=o)),
              f"attention_lse_bwd L={l} H={h} {dn}: a second call gave other bits")
        ms4 = time_ms(lambda: attn.attention_lse_bwd(q, k, v, do, m, s, scale, out=out), iters=5)
        plain4 = time_ms(lambda: attn.attention_lse_bwd_ref(q, k, v, do, m, s, scale),
                         iters=2, warmup=1)
        rec = attn.attention_bwd(q, k, v, do, scale)
        check(all(bool(torch.equal(a, r)) for a, r in zip(out, rec)),
              f"attention_bwd L={l} {dn}: not bitwise equal to attention_lse_bwd")
        check(repeats(torch, rec, lambda o: attn.attention_bwd(q, k, v, do, scale, out=o)),
              f"attention_bwd L={l} H={h} {dn}: a second call gave other bits")
        ms2 = time_ms(lambda: attn.attention_bwd(q, k, v, do, scale), iters=5)
        # #1 recompute forward: o equal to #3's bit for bit
        with switches(store_lse=False):
            o1 = attn.attention_fwd(q, k, v, scale)
            ms1 = time_ms(lambda: attn.attention_fwd(q, k, v, scale), iters=5)
        check(bool(torch.equal(o1, o)), f"attention_fwd L={l} {dn}: o differs from #3's")
        torch.cuda.synchronize()
        rows[dn] = dict(ms3=ms3, sdpa=sdpa_ms, ms4=ms4, ms2=ms2, sdpa_bwd=sdpa_bwd_ms,
                        fwd_bound=fwd_bound, bwd_bound=bwd_bound)
        print(f"[{tag}] {dn} B={b} L={l} H={h} D={d}: #3 attention_lse_fwd max_abs_err "
              f"o={err3:.3e}{flips}, {ms3:.4f} ms (plain {plain3:.4f}, sdpa {sdpa_ms:.4f}, bound "
              f"{fwd_bound:.4f} ({fwd_by}), {fwd_bound / ms3:.3f} of it); #4 attention_lse_bwd "
              f"{rel4:.2e} of max |ref|, {ms4:.4f} ms (plain {plain4:.4f}, sdpa backward "
              f"{sdpa_bwd_ms:.4f}, bound {bwd_bound:.4f} ({bwd_by}), {bwd_bound / ms4:.3f} of it); "
              f"#1 attention_fwd {ms1:.4f} ms, o equal to #3's; #2 attention_bwd {ms2:.4f} ms, "
              f"equal to #4 bit for bit; #4 and #2 each equal to a second call bit for bit")
        del qkv, q, k, v, do, o, m, s, dqkv, out, rec, o1
        torch.cuda.empty_cache()
    return rows


def phase_kinds_cli(torch, np, d, ft_out):
    """The fine-tuning CLI for three of the kinds on [finetune cli]'s LMDBs
    (1 epoch of 2 steps + eval, launches of every step and eval batch
    asserted, log.txt finite), then the predict CLI for two more on the
    512-record LMDB (every TSV line checked)."""
    from dig_tpu_torch.cli.run_predict import main as predict_main
    from dig_tpu_torch.config import PredictConfig, parse_config

    teacher = os.path.join(ft_out, f"checkpoint-{FT_CLI_EPOCHS - 1}")
    runs = {
        "--decoder_type attention": (["--decoder_type", "attention"], FT_PER_STEP,
                                     FT_EVAL_BATCH),
        "--use_seq_cls_token": (["--use_seq_cls_token", "--model", SEQ_CLS_MODEL], SEQ_CLS_STEP,
                                SEQ_CLS_EVAL),
        "--use_feat_distill": (["--use_feat_distill", "--teacher_ckpt", teacher],
                               KIND_STEP_DISTILL, FT_EVAL_BATCH),
    }
    counts_all = per_step()
    for label, (extra, want, want_eval) in runs.items():
        tag = f"kinds cli {label}"
        out = os.path.join(d, "kinds_" + extra[0].strip("-"))
        argv = ["--data_path", os.path.join(d, "labelled"), "--eval_data_path",
                os.path.join(d, "labelled_eval"), "--output_dir", out, "--epochs", "1", *extra]
        state, steps, evals, counts, dt = run_finetune_cli(torch, tag, argv)
        n_steps = FT_CLI_RECORDS // FT_BATCH
        check(len(steps) == n_steps and len(evals) == -(-FT_CLI_EVAL_RECORDS // FT_BATCH),
              f"[{tag}] {len(steps)} steps, {len(evals)} eval batches")
        check_each(tag, "step", steps, want)
        check_each(tag, "eval batch", evals, want_eval)
        with open(os.path.join(out, "log.txt")) as f:
            log = [json.loads(line) for line in f]
        check(len(log) == 1 and all(math.isfinite(v) for k, v in log[0].items()
                                    if k.startswith("train_")) and log[0]["val_acc"] is not None,
              f"[{tag}] log.txt {log}")
        counts_all = {k: counts_all[k] + counts[k] for k in counts}
        print(f"[{tag}] run_finetune.main at FinetuneConfig defaults, bf16 batch {FT_BATCH}, 1 "
              f"epoch of {n_steps} steps + eval of {FT_CLI_EVAL_RECORDS} records in {dt:.3f} s "
              f"(model build included); launches {launches_text(steps[0][0])} at every step, "
              f"{launches_text(evals[0][0])} every eval batch; log "
              f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in log[0].items()} }")
        del state
        torch.cuda.empty_cache()
    db = os.path.join(d, "labelled")
    for label, extra, want in (
            ("--model_kind ctc", ["--model_kind", "ctc"], FT_EVAL_BATCH),
            ("--decoder_name decoupled_tf_decoder", ["--decoder_name", "decoupled_tf_decoder"],
             FT_EVAL_BATCH)):
        tsv = os.path.join(d, "kinds_" + extra[1] + ".tsv")
        cfg = parse_config(PredictConfig, ["--data_path", db, "--output", tsv, *extra])
        reset_counts()
        t0 = time.perf_counter()
        n = predict_main(cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        batches = -(-FT_CLI_RECORDS // cfg.batch_size)
        check(counts == {k: v * batches for k, v in want.items()},
              f"[kinds cli predict {label}] launches {counts}")
        with open(tsv) as f:
            lines = f.read().splitlines()
        check(n == len(lines) == FT_CLI_RECORDS, f"{n} recognized, {len(lines)} lines")
        for i, line in enumerate(lines, start=1):
            fields = line.split("\t")
            check(len(fields) == 3 and fields[0] == f"{db}#{i}"
                  and 0.0 < float(fields[2]) <= 1.0, f"TSV line {line!r}")
        print(f"[kinds cli predict {label}] run_predict.main, bf16 batch {cfg.batch_size}: "
              f"{n} lines in {dt:.3f} s (model build included); launches "
              f"{launches_text(counts)}; first line {lines[0]!r}")
        counts_all = {k: counts_all[k] + counts[k] for k in counts}
    return counts_all


FWD_MODES = ("kStats", "kPlain", "kBf16Exp")
FWD_SWEEPS = ("two sweeps", "resident")
BWD_MODES = ("stored statistics", "kRecompute")


# an attention body's mangled name -> its template arguments as text
PTXAS_NAMES = [
    (r"(attn_fwd_wgmma_kernel)ILi(\d+)ELNS_7FwdModeE(\d)ELb([01])E",
     lambda m: f"{m[1]}<D={m[2]}, {FWD_MODES[int(m[3])]}, {FWD_SWEEPS[int(m[4])]}>"),
    (r"(attn_fwd_fma_kernel)ILi(\d+)ELNS_7FwdModeE(\d)E",
     lambda m: f"{m[1]}<D={m[2]}, {FWD_MODES[int(m[3])]}>"),
    (r"(attn_bwd_rows_kernel)ILi(\d+)ELb([01])ELb([01])E",
     lambda m: f"{m[1]}<D={m[2]}, {BWD_MODES[int(m[3])]}, {FWD_SWEEPS[int(m[4])]}>"),
    (r"(attn_bwd_cols_kernel)ILi(\d+)E", lambda m: f"{m[1]}<D={m[2]}>"),
    (r"(attn_bwd_dq_kernel)ILi(\d+)ELb([01])E",
     lambda m: f"{m[1]}<D={m[2]}, {BWD_MODES[int(m[3])]}>"),
    (r"(attn_bwd_dkdv_kernel)ILi(\d+)E", lambda m: f"{m[1]}<D={m[2]}>"),
]
# ---------------------------------------------------------------------------
# the options dig_tpu runs (--remat, --patchnet_name conv, every --opt),
# and the fine-tuning steps' reproducibility
# ---------------------------------------------------------------------------

# --remat: the student encoder's 12 blocks run their forward again inside
# the backward (`torch.utils.checkpoint`); the momentum branch runs without
# gradients and is not recomputed.  So a step launches #3 12 (student) + 12
# (momentum) + 12 (recompute) = 36 and #5 twice that, #4 12 and #6 24 as
# without remat.
REMAT_PER_STEP = per_step(attention_lse_fwd=36, attention_lse_bwd=12, layer_norm_fwd=72,
                          layer_norm_bwd=24)
SLICE8_WARMUP, SLICE8_STEPS = 2, 5
OPT_STEPS = 7  # updates of each optimizer, card against CPU
CONV_PARITY_BATCH = 8  # the conv extractor gives one InfoNCE key an image; top-5 needs 5
OPT_SHAPES = {"encoder.pos_embed": (1, 4, 8), "encoder.patch_embed.proj.weight": (8, 12),
              "encoder.blocks.0.w": (8, 8), "encoder.blocks.0.b": (8,),
              "encoder.blocks.1.w": (128, 160), "encoder.blocks.1.norm": (160,),
              "head.w": (160, 6), "head.b": (6,)}
OPT_TOL = 1e-6  # parameters after the updates, card vs CPU (relative and absolute)
DETERMINISM_KINDS = {"rec": {}, "ctc": dict(model_kind="ctc"), "attn": dict(model_kind="attn"),
                     "mim_rec": dict(model_kind="mim_rec"),
                     "decoupled": dict(decoder_name="decoupled_tf_decoder"),
                     "seq_cls": dict(model=SEQ_CLS_MODEL, model_kind="seq_cls"),
                     "distill": dict(use_feat_distill=True)}


def optimizer_names():
    """Every name of `dig_tpu/optim.py:266-310` with its aliases, and the
    lookahead prefix on three of them."""
    from dig_tpu_torch.optim import RULES

    return sorted(RULES) + ["lookahead_adamw", "lookahead_lamb", "lookahead_sgd"]


def phase_pretrain_remat(torch, np):
    """`--remat` on the pre-training step at full width: bf16 batch 128,
    remat off and on (ms a step, peak memory, launches); then one step from
    one state and batch with drop-path 0.1 and one generator, remat off
    against on, in fp32 (loss and every gradient bit for bit) and bf16
    (reported)."""
    tag = "pretrain remat"
    res = {}
    for remat in (False, True):
        model, state, step, batch_np = pretrain_setup(torch, np, torch.bfloat16, PRE_BATCH, "cuda",
                                                      remat=remat)
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(SLICE8_WARMUP):
            step(state, batch)
        torch.cuda.synchronize()
        reset_counts()
        results, dt, times = timed_steps(torch, lambda: step(state, batch), SLICE8_STEPS)
        counts = read_counts()
        check_counts(f"[{tag}]", counts, REMAT_PER_STEP if remat else PER_STEP, SLICE8_STEPS)
        losses = torch.stack([m["loss"] for _, m in results]).float().cpu()
        check(bool(torch.isfinite(losses).all()), f"[{tag}] non-finite loss {losses.tolist()}")
        res[remat] = (sorted(times)[len(times) // 2], dt / SLICE8_STEPS * 1e3,
                      torch.cuda.max_memory_allocated() / 2**30,
                      {k: v // SLICE8_STEPS for k, v in counts.items() if v})
        del model, state, batch, results
        torch.cuda.empty_cache()
    for remat, (med, host, peak, launches) in res.items():
        print(f"[{tag}] bf16 batch {PRE_BATCH}, remat {'on' if remat else 'off'}: {med:.2f} ms a "
              f"step (median of {SLICE8_STEPS} on the card's clock; {host:.2f} ms by the host's), "
              f"peak memory {peak:.2f} GiB, launches a step {launches}")
    for dtype in (torch.float32, torch.bfloat16):
        out = {}
        for remat in (False, True):
            model, state, step, batch_np = pretrain_setup(
                torch, np, dtype, PRE_BATCH, "cuda", seed=2, start_step=500, remat=remat,
                drop_path_rate=0.1)
            gen = torch.Generator(device="cuda").manual_seed(7)
            _, metrics = step(state, batch_np, gen)
            out[remat] = (metrics["loss"].clone(),
                          {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.requires_grad}, gen.get_state())
            del model, state
        (la, ga, sa), (lb, gb, sb) = out[False], out[True]
        differ = [n for n in ga if not torch.equal(ga[n], gb[n])]
        worst = max((float((ga[n] - gb[n]).abs().max()) / max(float(ga[n].abs().max()), 1e-30)
                     for n in ga), default=0.0)
        name = "fp32" if dtype == torch.float32 else "bf16"
        print(f"[{tag}] {name} batch {PRE_BATCH}, drop-path 0.1, one card generator: remat "
              f"against the plain step: loss {float(lb):.7f} vs {float(la):.7f} "
              f"({'equal' if torch.equal(la, lb) else 'different'}), {len(ga) - len(differ)} of "
              f"{len(ga)} gradients equal bit for bit (worst {worst:.2e} of a leaf's max), the "
              f"generator's state {'equal' if torch.equal(sa, sb) else 'different'} after")
        if dtype == torch.float32:
            check(torch.equal(la, lb) and not differ and torch.equal(sa, sb),
                  f"[{tag}] fp32 remat step differs from the plain one: {differ[:4]}")
        del out, ga, gb
        torch.cuda.empty_cache()


def phase_pretrain_conv(torch, np, paths):
    """`--patchnet_name conv` on the pre-training step: bf16 batch 128 at
    full width (ms a step, launches: the conv extractor runs no kernel, so
    the encoder's counts); then fp32 at batch 8 (one key an image: InfoNCE's
    top-5 accuracy needs 5), full width and depth 2,
    card against CPU as `[pretrain cpu parity]` holds the regular step
    (`models/layers.py::_exact_conv`: in fp32 PyTorch's own convolution,
    cuDNN off, in the conv's forward and backward; `conv_backends` reports
    why)."""
    tag = "pretrain conv patchnet"
    model, state, step, batch_np = pretrain_setup(torch, np, torch.bfloat16, PRE_BATCH, "cuda",
                                                  patchnet_name="conv")
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SLICE8_WARMUP):
        step(state, batch)
    torch.cuda.synchronize()
    reset_counts()
    results, dt, times = timed_steps(torch, lambda: step(state, batch), SLICE8_STEPS)
    counts = read_counts()
    check_counts(f"[{tag}]", counts, PER_STEP, SLICE8_STEPS)
    losses = torch.stack([m["loss"] for _, m in results]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"[{tag}] non-finite loss {losses.tolist()}")
    n_conv = sum(p.numel() for n, p in model.named_parameters()
                 if n.startswith("patch_extractor."))
    print(f"[{tag}] bf16 batch {PRE_BATCH}: {step_times_text(times)} on the card's clock, "
          f"{dt / SLICE8_STEPS * 1e3:.2f} ms by the host's; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the conv extractor "
          f"{n_conv / 1e6:.2f} M parameters; launches a step "
          f"{launches_text({k: v // SLICE8_STEPS for k, v in counts.items()})}; losses "
          f"{[round(x, 5) for x in losses.tolist()]}")
    paths["pretrain_conv"] = counts
    del model, state, batch, results
    torch.cuda.empty_cache()
    conv_backends(torch, tag)
    runs = {}
    for device in ("cpu", "cuda"):
        model, state, step, batch_np = pretrain_setup(torch, np, torch.float32, CONV_PARITY_BATCH,
                                                      device, seed=1, start_step=500,
                                                      patchnet_name="conv", encoder_depth=2)
        reset_counts()
        _, metrics = step(state, batch_np)
        if device == "cuda":
            torch.cuda.synchronize()
            got = read_counts()
            want = per_step(attention_lse_fwd=4, attention_lse_bwd=2, layer_norm_fwd=8,
                            layer_norm_bwd=4)
            check(got == want, f"[{tag}] the fp32 card step's launches {got} != {want}")
        runs[device] = (float(metrics["loss"]), {n: p.grad.detach().cpu() for n, p in
                                                 model.named_parameters() if p.requires_grad})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    worst, worst_name = leaf_parity(f"[{tag}]", l_cpu, l_gpu, g_cpu, g_gpu)
    print(f"[{tag}] fp32 batch {CONV_PARITY_BATCH}, full width, depth 2: loss {l_gpu:.7f} (card) "
          f"vs {l_cpu:.7f} "
          f"(cpu); {len(g_cpu)} gradient leaves within {STEP_RTOL} of their max |g| (floor "
          f"{STEP_FLOOR} of the largest); worst {worst:.2e} ({worst_name})")


def conv_backends(torch, tag):
    """The fp32 convolution backends the conv extractor could take, at its
    first block's shape in a pre-training step (256 maps of 8 x 32, 384 ->
    576 channels, 3 x 3): forward, input and weight gradients against fp64
    on the CPU (max error over max |value|), bit-equality of two runs, and
    ms for forward + backward.  `models/layers.py::_exact_conv` takes
    PyTorch's own (cuDNN off) in fp32."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    x = torch.randn(PRE_B, 384, 8, 32, generator=g, dtype=torch.float64)
    w = torch.randn(576, 384, 3, 3, generator=g, dtype=torch.float64) * 0.02
    go = torch.randn(PRE_B, 576, 8, 32, generator=g, dtype=torch.float64)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = F.conv2d(xr, wr, padding=1)
    ref.backward(go)
    rel = lambda a, b: float((a.double().cpu() - b).abs().max() / b.abs().max())  # noqa: E731
    rows = []
    for label, flags in (("PyTorch's own (cuDNN off)", dict(enabled=False)),
                         ("cuDNN deterministic", dict(enabled=True, allow_tf32=False)),
                         ("cuDNN default (TF32)", dict(enabled=True, allow_tf32=True))):
        outs = []
        with torch.backends.cudnn.flags(benchmark=False, deterministic=True, **flags):
            xg, wg = x.float().cuda().requires_grad_(), w.float().cuda().requires_grad_()
            gg = go.float().cuda()

            def run():
                xg.grad = wg.grad = None
                y = F.conv2d(xg, wg, padding=1)
                y.backward(gg)
                return y.detach()

            for _ in range(2):
                y = run()
                outs.append((y, xg.grad.clone(), wg.grad.clone()))
            ms = time_ms(run, iters=5)
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        rows.append(f"{label}: fwd {rel(outs[0][0], ref.detach()):.1e}, dx "
                    f"{rel(outs[0][1], xr.grad):.1e}, dw {rel(outs[0][2], wr.grad):.1e}, "
                    f"{'bit-equal' if same else 'NOT bit-equal'} twice, {ms:.2f} ms fwd + bwd")
    print(f"[{tag}] fp32 conv backends at {PRE_B} x 384 x 8 x 32 -> 576 (error over max |value| "
          f"against fp64): " + "; ".join(rows))


def _optimizer_run(torch, np, name, device, update_freq):
    """`name` over OPT_STEPS updates (x `update_freq` micro-steps) of the
    OPT_SHAPES parameters on `device`: clipping, layer decay 0.75 over two
    blocks, the first block and the embeddings frozen, lr and wd schedules;
    gradients (and AdaHessian's Hessian diagonal) from numpy seeds."""
    from dig_tpu_torch.optim import create_optimizer, frozen_encoder_mask

    rng = np.random.default_rng(11)
    params = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
              .requires_grad_() for n, s in OPT_SHAPES.items()}
    lr = np.linspace(1e-2, 3e-3, OPT_STEPS).astype(np.float32)
    wd = np.linspace(0.05, 0.1, OPT_STEPS).astype(np.float32)
    opt = create_optimizer(name, params.items(), lr, wd, clip_grad=3.0, layer_decay=0.75,
                           num_layers=2, frozen=frozen_encoder_mask(1), update_freq=update_freq)
    diag = [torch.from_numpy(rng.uniform(0.5, 2, size=s).astype(np.float32)).to(device)
            for s in OPT_SHAPES.values()]
    for _ in range(OPT_STEPS * update_freq):
        scale = 10.0 ** rng.uniform(-2.5, -0.5)
        for n, p in params.items():
            p.grad = torch.from_numpy((scale * rng.normal(size=p.shape)).astype(np.float32)).to(
                device)
        if name == "adahessian":
            opt.step(hess_diag=diag)
        else:
            opt.step()
    check(opt.count == OPT_STEPS, f"[optimizers] {name}: {opt.count} updates")
    return {n: p.detach().cpu() for n, p in params.items()}


def phase_optimizers(torch, np):
    """Every optimizer name: fp32 on the card against the CPU path
    (`_optimizer_run`; and LAMB at `update_freq` 2), each parameter within
    OPT_TOL; then each name takes 3 bf16 pre-training steps at full width
    on one model (launches asserted, loss finite; AdaHessian's step raises
    `ValueError`, as in `dig_tpu`: no step hands it a Hessian diagonal)."""
    tag = "optimizers"
    names = optimizer_names()
    t0 = time.perf_counter()
    worst = 0.0
    for name in names:
        for update_freq in ((1, 2) if name == "lamb" else (1,)):
            cpu = _optimizer_run(torch, np, name, "cpu", update_freq)
            gpu = _optimizer_run(torch, np, name, "cuda", update_freq)
            for n in cpu:
                err = float((gpu[n] - cpu[n]).abs().max())
                check(err <= OPT_TOL * (1 + float(cpu[n].abs().max())),
                      f"[{tag}] {name} update_freq {update_freq}: {n} card vs CPU {err}")
                worst = max(worst, err)
    print(f"[{tag}] {len(names)} names ({', '.join(names)}) and lamb at update_freq 2: fp32, "
          f"{OPT_STEPS} updates with clipping, layer decay, a frozen block and no-decay "
          f"parameters, card = CPU within {OPT_TOL} (worst {worst:.2e}) in "
          f"{time.perf_counter() - t0:.1f} s")
    from dig_tpu_torch.optim import create_optimizer
    from dig_tpu_torch.config import PretrainConfig

    cfg = PretrainConfig()
    model, state, step, batch_np = pretrain_setup(torch, np, torch.bfloat16, PRE_BATCH, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    lr, wd = state.optimizer.lr, state.optimizer.wd
    rows = []
    for name in names:
        state.optimizer = create_optimizer(name, model.named_parameters(), lr, wd,
                                           betas=cfg.opt_betas, eps=cfg.opt_eps,
                                           clip_grad=cfg.clip_grad)
        if name == "adahessian":
            try:
                step(state, batch)
            except ValueError as e:
                check("hutchinson_hessian_diag" in str(e), f"[{tag}] adahessian: {e}")
                rows.append("adahessian ValueError (no Hessian diagonal)")
                continue
            check(False, f"[{tag}] adahessian stepped without a Hessian diagonal")
        torch.cuda.synchronize()
        reset_counts()
        results, dt, times = timed_steps(torch, lambda: step(state, batch), 3)
        check_counts(f"[{tag} {name}]", read_counts(), PER_STEP, 3)
        losses = [float(m["loss"]) for _, m in results]
        check(all(math.isfinite(x) for x in losses), f"[{tag}] {name}: losses {losses}")
        rows.append(f"{name} {statistics.median(times):.1f} ms")
    print(f"[{tag}] bf16 batch {PRE_BATCH}, 3 pre-training steps each on one model (ms a step, "
          f"median on the card's clock; launches {launches_text(PER_STEP)} a step): "
          + "; ".join(rows))
    del model, state, batch
    torch.cuda.empty_cache()


def phase_pretrain_cli_options(torch, np, db, root):
    """`run_pretrain.main` with `--remat --patchnet_name conv --opt lamb
    --drop_path 0.1` at the PretrainConfig defaults on the LMDB, 2 epochs of
    4 steps (launches asserted at every step); then the same argv in fp32
    with `--device_aug` (which makes a run a function of (seed, step)):
    straight against auto-resumed, bit for bit, LAMB's state included."""
    tag = "pretrain cli options"
    options = ["--remat", "--patchnet_name", "conv", "--opt", "lamb", "--drop_path", "0.1"]
    out = os.path.join(root, "options")
    argv = ["--image_alone_path", db, "--output_dir", out, "--epochs", str(PRE_CLI_EPOCHS),
            *options]
    state, counts, dt = run_pretrain_cli(torch, tag, argv, PRE_CLI_STEPS, want=REMAT_PER_STEP)
    check(state.optimizer.rule == "lamb" and state.model.encoder.remat,
          f"[{tag}] the run did not take its options")
    log, screen = check_cli_outputs(out, tag)
    s_it, s_data = epoch_rate(screen, PRE_CLI_EPOCHS - 1)
    print(f"[{tag}] run_pretrain.main {' '.join(options)}, bf16 batch {PRE_BATCH}, "
          f"{PRE_CLI_EPOCHS} epochs of {PRE_CLI_STEPS // PRE_CLI_EPOCHS} steps in {dt:.3f} s; the "
          f"last epoch {s_it * 1e3:.1f} ms a step by the CLI's clock, waiting {s_data * 1e3:.1f} "
          f"ms; launches per step {launches_text({k: v // PRE_CLI_STEPS for k, v in counts.items()})}"
          f"; epoch losses {[round(l['train_loss'], 5) for l in log]}")
    del state
    half = PRE_CLI_STEPS // PRE_CLI_EPOCHS
    fp32 = lambda name: ["--image_alone_path", db, "--output_dir", os.path.join(root, name),  # noqa: E731
                         "--epochs", str(PRE_CLI_EPOCHS), *options, "--dtype", "float32",
                         "--device_aug"]
    a, _, dt_a = run_pretrain_cli(torch, tag + " A", fp32("options_a"), PRE_CLI_STEPS,
                                  want=REMAT_PER_STEP)
    run_pretrain_cli(torch, tag + " B first epoch", fp32("options_b"), half, cut_after_epoch=0,
                     want=REMAT_PER_STEP)
    b, _, _ = run_pretrain_cli(torch, tag + " B resumed", fp32("options_b"), PRE_CLI_STEPS - half,
                               want=REMAT_PER_STEP)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    check(not differ, f"[{tag}] {len(differ)} of {len(sa)} tensors differ, e.g. {differ[:4]}")
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    lamb = [(k, i) for k, ts in oa["inner"]["state"].items() for i in range(len(ts))]
    check(oa["count"] == ob["count"] and all(
        torch.equal(oa["inner"]["state"][k][i], ob["inner"]["state"][k][i]) for k, i in lamb),
        f"[{tag}] LAMB's state differs")
    with open(os.path.join(root, "options_a", "log.txt")) as fa, \
            open(os.path.join(root, "options_b", "log.txt")) as fb:
        check(fa.read() == fb.read(), f"[{tag}] the two runs' log.txt differ")
    print(f"[{tag}] fp32 {' '.join(options)} --device_aug: {PRE_CLI_EPOCHS} epochs straight "
          f"({dt_a:.3f} s) vs 1 epoch + a fresh main auto-resuming checkpoint-0 + 1 epoch: "
          f"{len(sa)} tensors and {len(lamb)} LAMB state tensors equal bit for bit; log.txt "
          f"equal byte for byte")
    del a, b
    torch.cuda.empty_cache()


def phase_finetune_cli_opt(torch, d, pre_ckpt):
    """`run_finetune.main` with `--opt adamp` (AdamP's projection and its
    wd_ratio) at the FinetuneConfig defaults from `[pretrain cli]`'s
    checkpoint: 1 epoch of 2 steps + eval, launches asserted."""
    tag = "finetune cli opt"
    out = os.path.join(d, "ft_adamp")
    argv = ["--data_path", os.path.join(d, "labelled"), "--eval_data_path",
            os.path.join(d, "labelled_eval"), "--finetune", pre_ckpt, "--output_dir", out,
            "--epochs", "1", "--opt", "adamp"]
    state, steps, evals, counts, dt = run_finetune_cli(torch, tag, argv)
    n_steps = FT_CLI_RECORDS // FT_BATCH
    check(len(steps) == n_steps and len(evals) == -(-FT_CLI_EVAL_RECORDS // FT_BATCH),
          f"[{tag}] {len(steps)} steps, {len(evals)} eval batches")
    check_each(tag, "step", steps, FT_PER_STEP)
    check_each(tag, "eval batch", evals, FT_EVAL_BATCH)
    check(state.optimizer.rule == "adamp" and state.optimizer.count == n_steps,
          f"[{tag}] optimizer {state.optimizer.rule} count {state.optimizer.count}")
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    check(len(log) == 1 and math.isfinite(log[0]["train_loss"]), f"[{tag}] log {log}")
    print(f"[{tag}] run_finetune.main --opt adamp, bf16 batch {FT_BATCH}, 1 epoch of {n_steps} "
          f"steps + eval of {FT_CLI_EVAL_RECORDS} records in {dt:.3f} s; the host queues a step in "
          f"(median) {statistics.median(t for _, t in steps) * 1e3:.1f} ms; launches "
          f"{launches_text(steps[0][0])} at every step, {launches_text(evals[0][0])} every eval "
          f"batch; loss {log[0]['train_loss']:.4f}, val acc {log[0]['val_acc']}")
    del state
    torch.cuda.empty_cache()


def gather_form_repeats(torch, np, repeats=20):
    """The op the CTC loss took its emit log-probabilities with before this
    port's repair, `torch.gather` along the class axis, at a CTC step's
    shapes (256 sequences x 32 frames x 98 classes, the labels of
    `labelled_batch`): its backward (an atomic scatter-add) repeated,
    counting the gradients that differ from the first.  Reported only: the
    loss no longer calls it (`losses/ctc.py`)."""
    from dig_tpu_torch.utils.charset import build_charset

    charset = build_charset("ALLCASES_SYMBOLS", 25)
    batch = labelled_batch(np, charset, 25, FT_BATCH, 0)
    labels = torch.from_numpy(batch["targets"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    logprobs = torch.randn(FT_BATCH, 32, 98, device="cuda", generator=gen).requires_grad_()
    idx = labels.clamp(0, 97)[:, None, :].expand(-1, 32, -1)
    # the padded positions (EOS on) take no gradient, as in the loss
    valid = np.arange(labels.shape[1])[None] < batch["lengths"][:, None] - 1
    grad_out = torch.randn(FT_BATCH, 32, labels.shape[1], device="cuda", generator=gen)
    grad_out = grad_out * torch.from_numpy(valid).cuda()[:, None, :]
    grads = []
    for _ in range(repeats):
        logprobs.grad = None
        torch.gather(logprobs, 2, idx).backward(grad_out)
        grads.append(logprobs.grad.clone())
    differ = sum(not torch.equal(grads[0], g) for g in grads[1:])
    triples = sum(int(np.bincount(row[v]).max() >= 3)
                  for row, v in zip(batch["targets"], valid) if v.any())
    print(f"[determinism] the gather form's backward (the CTC loss's op before the one-hot "
          f"repair) at {FT_BATCH} x 32 x 98, labelled_batch's labels ({triples} of {FT_BATCH} "
          f"words hold an id three times or more): {differ} of {repeats - 1} repeats differ "
          f"from the first")


def phase_determinism(torch, np):
    """Each fine-tuning kind at the FinetuneConfig defaults (bf16, batch 256,
    dropouts on, `labelled_batch`, whose words repeat ids): two steps from
    one state and one batch with the same generator, every gradient and
    parameter compared with `torch.equal`.  Then a third step under
    `torch.use_deterministic_algorithms(True, warn_only=True)`, only to name
    the ops that have no reproducible CUDA implementation."""
    import copy
    import gc
    import warnings

    tag = "determinism"
    gather_form_repeats(torch, np)
    for name, fields in DETERMINISM_KINDS.items():
        cfg, model, state, step, batch_np, charset, teacher = kind_setup(
            torch, np, fields, torch.bfloat16, FT_BATCH, "cuda")
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
        start = copy.deepcopy(model.state_dict())
        opt_start = copy.deepcopy(state.optimizer.state_dict())
        runs = []
        for _ in range(2):
            model.load_state_dict(start)
            state.optimizer.load_state_dict(opt_start)
            state.step = 0
            step(state, batch, torch.Generator(device="cuda").manual_seed(0))
            runs.append(({n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None},
                         {k: v.clone() for k, v in model.state_dict().items()}))
        (ga, pa), (gb, pb) = runs
        differ = [n for n in ga if not torch.equal(ga[n], gb[n])]
        moved = [k for k in pa if not torch.equal(pa[k], pb[k])]
        model.load_state_dict(start)
        state.optimizer.load_state_dict(opt_start)
        flagged = set()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                step(state, batch, torch.Generator(device="cuda").manual_seed(0))
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        for w in caught:
            text = str(w.message)
            if "deterministic" in text:
                flagged.add(text.split(" does not have a deterministic")[0][:100])
        print(f"[{tag}] {name}: two steps from one state, bf16 batch {FT_BATCH}: "
              f"{len(ga) - len(differ)} of {len(ga)} gradients and {len(pa) - len(moved)} of "
              f"{len(pa)} tensors after the update equal bit for bit"
              + (f"; differ: {differ[:6]}" if differ else "")
              + f"; ops without a deterministic CUDA implementation: "
              f"{sorted(flagged) if flagged else 'none'}")
        check(not differ and not moved, f"[{tag}] {name}: the step does not repeat its bits "
                                        f"({len(differ)} gradients, {len(moved)} tensors differ)")
        del model, state, step, batch, start, opt_start, runs, ga, gb, pa, pb, teacher
        gc.collect()
        torch.cuda.empty_cache()


# bench_torch.py's modes at their defaults, each a child process, with the
# launches each must make a step (an eval batch) of its timed window; the
# input mode's demand is the bare pre-training step's
BENCH_LAUNCHES = {"pretrain": PER_STEP, "finetune": FT_PER_STEP_RESUME, "eval": FT_EVAL_BATCH,
                  "input": PER_STEP}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
BENCH_MODE_KEYS = {
    "pretrain": BENCH_KEYS | {"step_ms", "mfu", "step_tflops", "breakdown_ms"},
    "finetune": BENCH_KEYS | {"step_ms", "mfu", "step_tflops"},
    "eval": BENCH_KEYS,
    "input": BENCH_KEYS | {"host_cores", "workers", "pretrain_seqclr_aug", "finetune_abi_aug",
                           "finetune_plain", "per_core", "device_demand_pretrain"}}
BENCH_TIMEOUT = 300  # seconds a mode's child may take, its start included


def phase_bench_torch(smi):
    """`python bench_torch.py` in each mode at its defaults, as a user runs
    it: the keys of bench.py's line and the card's name and power limit,
    value > 0, 0 < mfu <= 1, every part of the breakdown > 0 and the
    step's busy time within its wall time, and the launches a step the
    child reports from the port's counters.  The pretrain line is the
    pre-training step's time and idle share; `[pretrain]` only checks it."""
    t_phase = time.perf_counter()
    for mode, want in BENCH_LAUNCHES.items():
        env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
        env["BENCH_MODE"] = mode
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        dt = time.perf_counter() - t0
        tag = f"[bench_torch {mode}]"
        check(proc.returncode == 0, f"{tag} exit {proc.returncode}: {proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        check(set(line) == BENCH_MODE_KEYS[mode], f"{tag} keys {sorted(line)}")
        check(line["value"] > 0 and line["device"] == smi, f"{tag} {line}")
        if mode in ("pretrain", "finetune"):
            check(0 < line["mfu"] <= 1, f"{tag} mfu {line['mfu']}")
        if mode == "pretrain":
            b = line["breakdown_ms"]
            check(min(b["student_fwd"], b["key_fwd"], b["bwd_opt"]) > 0
                  and b["step_device"] <= line["step_ms"], f"{tag} breakdown_ms {b}")
            print(f"{tag} a step: {line['step_ms']} ms wall, {b['step_device']} ms busy "
                  f"(idle share {1 - b['step_device'] / line['step_ms']:.3f})")
        reported = [x for x in proc.stderr.splitlines()
                    if x.startswith("bench_torch: launches per step ")]
        check(reported, f"{tag} reported no launches")
        launches = json.loads(reported[-1][len("bench_torch: launches per step "):])
        check(launches == want, f"{tag} launches a step {launches} != {want}")
        print(f"{tag} {smi}: {json.dumps(line)}; launches a step {launches_text(want)}, "
              f"asserted; the child took {dt:.1f} s")
    print(f"[bench_torch] four modes in {time.perf_counter() - t_phase:.1f} s")


def study_steps(log, pattern):
    """Steps an epoch, from a training stage's log line."""
    found = re.findall(pattern, log)
    check(found, f"[validation study] no {pattern!r} line")
    return int(found[-1])


def start_validation_study():
    """The validation study's runner as a child at STUDY_KNOBS, in a
    temporary directory, its output in files there; `phase_validation_study`
    waits for it.  Its corpora are rendered first, packed and unpacked
    into its workdir.  Returns (process, directory, start time, the
    corpora's manifest sha256)."""
    import importlib.util
    import tempfile

    d = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    runner = [sys.executable, "-m", "dig_tpu_torch.tools.validation_study"]
    made = subprocess.run([*runner, os.path.join(d.name, "render"), *STUDY_KNOBS, "--stages",
                           "corpusA,corpusB"], cwd=ROOT, capture_output=True, text=True,
                          timeout=STUDY_TIMEOUT)
    check(made.returncode == 0, f"[validation study] render exit {made.returncode}: "
                                f"{made.stdout[-2000:]}{made.stderr[-2000:]}")
    spec = importlib.util.spec_from_file_location(
        "study_corpora", os.path.join(ROOT, "tools", "study_corpora.py"))
    corpora = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpora)
    archive = os.path.join(d.name, "corpora.tar.xz")
    digest = corpora.pack(os.path.join(d.name, "render"), archive)
    check(corpora.unpack(archive, os.path.join(d.name, "w")) == digest,
          "[validation study] unpack's manifest sha256 is not pack's")
    print(f"[validation study] corpora rendered, packed ({os.path.getsize(archive)} B, xz) and "
          f"unpacked in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(d.name, "stdout"), "w") as out, \
            open(os.path.join(d.name, "stderr"), "w") as err:
        proc = subprocess.Popen([*runner, os.path.join(d.name, "w"), *STUDY_KNOBS], cwd=ROOT,
                                stdout=out, stderr=err)
    return proc, d, time.perf_counter(), digest


def phase_validation_study(smi, paths, started):
    """Waits for the runner `start_validation_study` started: each training
    stage's device, launches and result (see item 16)."""
    import cv2

    proc, tmp, t0, digest = started
    with tmp:
        def text(*parts):
            with open(os.path.join(tmp.name, *parts)) as f:
                return f.read()

        try:
            rc = proc.wait(timeout=max(1.0, STUDY_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        dt = time.perf_counter() - t0
        stdout = text("stdout")
        check(rc == 0, f"[validation study] exit {rc}: {stdout[-2000:]}{text('stderr')[-3000:]}")
        check("=== results (best test word accuracy per arm) ===" in stdout,
              "[validation study] printed no results block")
        res = json.loads(text("w", "results.json"))
        logs = {name: text("w", "logs", f"{name}.log") for name in ("pretrain", "ft_scratch",
                                                                  "ft_ssl")}
        ck = os.path.join(tmp.name, "w", "pre", f"checkpoint-{STUDY_PRE_EPOCHS - 1}")
    check(res["card"] == smi, f"[validation study] card {res['card']!r} != {smi!r}")
    stages = res["stages"]
    check(set(stages) == {"corpusA", "corpusB", "pretrain", "ft_scratch", "ft_ssl"},
          f"[validation study] stages {sorted(stages)}")
    check(not re.search(r"^\[corpus[AB]\]", stdout, re.M),
          "[validation study] the runner made a corpus that was carried in")
    for name in ("corpusA", "corpusB"):
        check((stages[name].get("opencv"), stages[name].get("manifest_sha256"))
              == (cv2.__version__, digest), f"[validation study] {name} {stages[name]}: "
                                            f"not OpenCV {cv2.__version__}, manifest {digest}")
    pre_steps = study_steps(logs["pretrain"], r"dataset: \d+ imgs, (\d+) steps/epoch")
    want = {"pretrain": {k: v * pre_steps * STUDY_PRE_EPOCHS for k, v in STUDY_PRE_STEP.items()}}
    for arm in ("ft_scratch", "ft_ssl"):
        steps = study_steps(logs[arm], r"train: \d+ imgs, (\d+) steps/epoch")
        want[arm] = {k: (STUDY_FT_STEP[k] * steps + STUDY_EVAL_BATCH[k] * STUDY_EVAL_BATCHES)
                     * STUDY_FT_EPOCHS for k in KERNEL_NAMES}
        r = res["arms"][arm]
        accs = [r["best_word_acc"], r["best_char_f"], *r["word_acc_by_epoch"]]
        check(len(r["word_acc_by_epoch"]) == STUDY_FT_EPOCHS
              and all(a is not None and 0 <= a <= 1 for a in accs), f"[validation study] {arm} {r}")
    init = res["arms"]["ft_ssl"]["init"]
    check(init is not None and int(init[0]) > 0 and init[1] == ck,
          f"[validation study] ft_ssl initialised from {init}, not {ck}")
    for name, counts in want.items():
        got = stages[name]
        check(got["device"].startswith("cuda"), f"[validation study] {name} on {got['device']}")
        check(got["launches"] == counts, f"[validation study] {name} launches "
                                         f"{got['launches']} != {counts}")
        paths[f"validation study {name}, a run"] = counts
    pre = res["pretrain"]
    check(all(math.isfinite(pre[k]["last"]) for k in ("loss_contrast", "loss_pixel", "q1_acc1")),
          f"[validation study] pretrain {pre}")
    print(f"[validation study] {smi}: " + "; ".join(
        f"{n} {s['seconds']:.1f} s on {s['device']}" for n, s in stages.items())
          + f"; corpora carried in, manifest sha256 {digest}, OpenCV {cv2.__version__}"
          + f"; the runner took {dt:.1f} s (beside the gloo phases); launches asserted: "
          + "; ".join(
        f"{n} {launches_text(c)}" for n, c in want.items()))
    print("[validation study] best word acc " + ", ".join(
        f"{arm} {r['best_word_acc']}" for arm, r in res["arms"].items())
          + f"; pretrain loss_contrast {pre['loss_contrast']['first']} -> "
            f"{pre['loss_contrast']['last']}, loss_pixel {pre['loss_pixel']['first']} -> "
            f"{pre['loss_pixel']['last']}")


def kernel_text(name):
    """A mangled kernel name as its template arguments, for an attention body."""
    for pattern, text in PTXAS_NAMES:
        m = re.search(pattern, name)
        if m:
            return text(m)
    return name[name.find("attn") if "attn" in name else 0:][:60]


def ptxas_kernels(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of one
    build's ptxas report, an attention body's name as
    attn_fwd_wgmma_kernel<D=64, kStats, resident>."""
    kernels, name, spills = [], "", (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_text(line.split("'")[1])
        elif "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = (int(m[1]), int(m[2]))
        elif "Used" in line and "registers" in line:
            kernels.append((name, int(line.split("Used")[1].split()[0]), *spills))
    return kernels


# the tensor-core instantiations at the model's head_dim, by source
MMA_D64 = {"attention_lse_fwd": ["attn_fwd_wgmma_kernel<D=64, kStats, resident>",
                                 "attn_fwd_wgmma_kernel<D=64, kStats, two sweeps>"],
           "attention_fwd": ["attn_fwd_wgmma_kernel<D=64, kPlain, resident>",
                             "attn_fwd_wgmma_kernel<D=64, kPlain, two sweeps>",
                             "attn_fwd_wgmma_kernel<D=64, kBf16Exp, resident>",
                             "attn_fwd_wgmma_kernel<D=64, kBf16Exp, two sweeps>"],
           "attention_lse_bwd": ["attn_bwd_rows_kernel<D=64, stored statistics, resident>",
                                 "attn_bwd_rows_kernel<D=64, stored statistics, two sweeps>",
                                 "attn_bwd_cols_kernel<D=64>"],
           "attention_bwd": ["attn_bwd_rows_kernel<D=64, kRecompute, resident>",
                             "attn_bwd_rows_kernel<D=64, kRecompute, two sweeps>",
                             "attn_bwd_cols_kernel<D=64>"]}


def serialised(log):
    """The kernels whose wgmma products ptxas serialised (its C7510-C7518
    "Potential Performance Loss" reports), by name."""
    return {kernel_text(m[2]) for m in re.finditer(r"\((C751[0-8])\).*function '(\S+)'", log)}


def print_ptxas():
    """Each build's registers, shared memory and spills; every attention
    instantiation by name.  Fails if a source has no report, if a bf16
    (tensor-core) attention body at D=64, the model's head_dim, forward or
    backward, is missing from its source's report, if it spills, or if
    ptxas serialised its wgmma products."""
    from dig_tpu_torch.ops import _build

    for name in SOURCES:
        log = _build.build_log(name)
        check(log is not None, f"no ptxas report for {name}")
        kernels = ptxas_kernels(log)
        check(kernels, f"no kernels in the ptxas report of {name}")
        regs = [k[1] for k in kernels]
        smem = sorted({int(line.split("bytes smem")[0].split()[-1])
                       for line in log.splitlines() if "bytes smem" in line})
        spills = [f"{k}: {st} bytes spill stores, {ld} bytes spill loads"
                  for k, _, st, ld in kernels if st or ld]
        print(f"[ptxas {name}] {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"static smem bytes {smem or [0]}, {len(spills)} with spills {spills}")
        for k, r, st, ld in kernels:
            if k.startswith(("attn_fwd_", "attn_bwd_")):
                print(f"[ptxas {name}]   {k}: {r} registers, {st} / {ld} bytes spilled "
                      f"(stores / loads)")
        found = {k: st + ld for k, _, st, ld in kernels}
        serial = serialised(log)
        if serial:
            print(f"[ptxas {name}]   wgmma serialised in {sorted(serial)}")
        for k in MMA_D64.get(name, []):
            check(k in found, f"{k} is not in the ptxas report of {name}")
            check(found[k] == 0, f"{k} spills")
            check(k not in serial, f"{k}: ptxas serialised its wgmma products")


def phase_logits_probe(torch, build):
    """The logits of every operand form the bf16 attention bodies take, on
    the same bf16 q and k (64 x 64 tiles at D=64, q scaled as the kernels
    scale it), against the forward's wgmma logits: the backward row pass's
    (A fragments by 32-bit shared loads) and column pass's (both operands
    from shared memory, keys as rows) must equal them bit for bit; the
    earlier backward's mma.sync logits are reported.  And each body's
    dynamic shared memory a block.  Not a wrapper: no launch is counted."""
    import ctypes

    lib = build.load("attention_probe")
    fn = lib.dig_attn_logits_forms
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dig_attn_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dig_attn_smem_bytes.restype = ctypes.c_longlong
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 4096
    q, k = (torch.randn(n, 64, 64, generator=gen, device="cuda").bfloat16() for _ in range(2))
    outs = [torch.empty(n, 64, 64, device="cuda") for _ in range(4)]
    qscale = torch.tensor(64**-0.5 * 1.4426950408889634, dtype=torch.bfloat16).item()
    build.check(lib, fn(q.data_ptr(), k.data_ptr(), *(o.data_ptr() for o in outs), n, qscale,
                        build.stream_ptr(q)), "attention logits probe")
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(o).all()) for o in outs), "logits probe: non-finite logits")
    fwd = outs[0].view(torch.int32)
    differ = {}
    for name, o in zip(("mma.sync", "backward rows", "backward columns"), outs[1:]):
        bits = o.view(torch.int32)
        differ[name] = int((bits != fwd).sum())
        ulps = int((bits.long() - fwd.long()).abs().max())
        print(f"[logits probe] {name} vs the forward's wgmma logits of {fwd.numel()} (q, k) pairs "
              f"at D=64: {'equal bit for bit' if differ[name] == 0 else 'NOT equal'} "
              f"({differ[name]} differ, at most {ulps} ulp apart)")
    for name in ("backward rows", "backward columns"):
        check(differ[name] == 0, f"logits probe: the {name} form differs from the forward's logits")
    for which, body in enumerate(("fwd", "bwd row pass", "bwd column pass")):
        smem = {d: lib.dig_attn_smem_bytes(which, d) for d in (32, 64, 128)}
        print(f"[ptxas attention {body}] the TMA / wgmma body's dynamic shared memory a block: "
              f"{smem} bytes (one block an SM)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from dig_tpu_torch.ops import _build
        from dig_tpu_torch.ops import attention as attn
        from dig_tpu_torch.ops import fused_dense as fd
        from dig_tpu_torch.ops import layernorm as ln
    except ImportError as e:
        print(f"chip_smoke: the dig_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    time_phases()
    _build.build_all(SOURCES)
    print(f"[build] {len(SOURCES)} kernels in {time.perf_counter() - t_start:.1f} s")
    print_ptxas()
    phase_logits_probe(torch, _build)

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = phase_attention(torch, attn, gen)
    ln_rows = phase_layernorm(torch, ln, gen)
    attn_bwd_rows = phase_attention_bwd(torch, attn, gen)
    ln_bwd_rows = phase_layernorm_bwd(torch, ln, gen)
    rec_rows = phase_attention_recompute(torch, attn, gen)
    rec_bwd_rows = phase_attention_bwd_recompute(torch, attn, gen)
    stress_counts = phase_attention_bwd_stress(torch, attn, gen)
    colsum_row = phase_colsum(torch, fd, gen)

    phase_to_model_images(torch, np)
    paths = {"predict": phase_predict(torch, np)}
    phase_host_images(np)
    paths["predict_cli"] = phase_predict_cli(torch, np)
    phase_cpu_parity(torch, np)
    paths["pretrain"] = phase_pretrain(torch, np, "pretrain", PER_STEP, measure=False)
    phase_pretrain_cpu_parity(torch, np, "pretrain cpu parity", PER_STEP)
    with switches(store_lse=False, fused_bias_grad=True):
        paths["pretrain_switches"] = phase_pretrain(torch, np, "pretrain switches",
                                                    PER_STEP_SWITCHES)
        with switches(store_lse=False, fused_bias_grad=True, bf16_exp=True):
            phase_pretrain(torch, np, "pretrain switches bf16_exp", PER_STEP_SWITCHES,
                           measure=False)
        phase_pretrain_cpu_parity(torch, np, "pretrain switches cpu parity", PER_STEP_SWITCHES_B2)
    paths["finetune"] = phase_finetune(torch, np, "finetune", FT_PER_STEP)
    with switches(fused_bias_grad=True):
        paths["finetune_switch"] = phase_finetune(torch, np, "finetune switch",
                                                  FT_PER_STEP_SWITCH, profile=False)
    paths["eval"] = phase_eval(torch, np, "eval", per_step(attention_lse_fwd=12, layer_norm_fwd=24))
    with switches(store_lse=False):
        paths["eval_switch"] = phase_eval(torch, np, "eval switch",
                                          per_step(attention_fwd=12, layer_norm_fwd=24))
    phase_finetune_cpu_parity(torch, np)
    l281_rows = phase_attention_l281(torch, attn, gen)
    phase_kinds_step(torch, np, paths)
    phase_memory_bank(torch, np)
    phase_kinds_cpu_parity(torch, np)
    phase_determinism(torch, np)
    phase_pretrain_remat(torch, np)
    phase_pretrain_conv(torch, np, paths)
    phase_optimizers(torch, np)
    phase_sync_debug_step(torch, np)
    phase_pretrain_data(torch, np, paths)
    # the pre-training step's attention on one tensor rank's heads (H / 2)
    split_rows = phase_attention_at(torch, attn, gen, "attention at the tensor split", PRE_B, L,
                                    H // 2)
    # the study's runner beside the gloo checks, which time nothing the line reports
    study = start_validation_study()
    phase_two_ranks_one_card(torch, np)
    phase_sharded_steps(torch, np)
    phase_validation_study(smi, paths, study)
    phase_bench_torch(smi)
    paths.update({f"bench_torch {mode}, a step": want for mode, want in BENCH_LAUNCHES.items()})

    def row(name, source, replaces, measured, path):
        stress = ({"stress_calls": stress_counts[name][0],
                   "stress_differing": stress_counts[name][1]} if name in stress_counts else {})
        return dict(name=name, route="cuda", source=f"dig_tpu_torch/ops/csrc/{source}.cu",
                    replaces=replaces, launches=paths[path][name],
                    launches_by_path={p: c[name] for p, c in paths.items()}, design=DESIGN[name],
                    bound_share=measured["bound_ms"] / measured["ms"], **stress, **measured)

    kernels = [
        row("attention_fwd", "attention_fwd", "dig_tpu/ops/attention.py:65",
            dict(rec_rows["bfloat16"], bf16_exp=rec_rows["bfloat16_bf16_exp"],
                 float32=rec_rows["float32"]),
            "pretrain_switches"),
        row("attention_bwd", "attention_bwd", "dig_tpu/ops/attention.py:111",
            dict(rec_bwd_rows["bfloat16"],
                 seq_cls={k: {"ms": v["ms2"], "sdpa_backward_ms": v["sdpa_bwd"]}
                          for k, v in l281_rows.items()},
                 tensor_split={k: {"ms": v["ms2"], "sdpa_backward_ms": v["sdpa_bwd"]}
                               for k, v in split_rows.items()}), "pretrain_switches"),
        row("attention_lse_fwd", "attention_lse_fwd", "dig_tpu/ops/attention.py:275",
            dict(attn_rows["bfloat16"], float32=attn_rows["float32"],
                 tensor_split={k: {"ms": v["ms3"], "sdpa_ms": v["sdpa"]}
                               for k, v in split_rows.items()}), "pretrain"),
        row("attention_lse_bwd", "attention_lse_bwd", "dig_tpu/ops/attention.py:299",
            dict(attn_bwd_rows["bfloat16"],
                 seq_cls={k: {"ms": v["ms4"], "sdpa_backward_ms": v["sdpa_bwd"]}
                          for k, v in l281_rows.items()},
                 tensor_split={k: {"ms": v["ms4"], "sdpa_backward_ms": v["sdpa_bwd"]}
                               for k, v in split_rows.items()}), "pretrain"),
        row("layer_norm_fwd", "layernorm_fwd", "dig_tpu/ops/layernorm.py:44", ln_rows["bfloat16"],
            "pretrain"),
        row("layer_norm_bwd", "layernorm_bwd", "dig_tpu/ops/layernorm.py:54",
            ln_bwd_rows["bfloat16"], "pretrain"),
        row("column_sum", "colsum", "dig_tpu/ops/fused_dense.py:37", colsum_row,
            "pretrain_switches"),
    ]
    left = stop_children()
    check(not left, f"processes left running at the end: {left}")
    print("[phase seconds] " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in sorted(PHASE_SECONDS.items(), key=lambda x: -x[1])))
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-child"]:  # started by run_ddp_clis through torchrun
        sys.exit(ddp_child(sys.argv[2]))
    if sys.argv[1:2] == ["--gloo-child"]:  # started by phase_two_ranks_one_card
        sys.exit(gloo_child(sys.argv[2]))
    if sys.argv[1:2] == ["--sharded-child"]:  # started by the sharded phases
        sys.exit(sharded_child(sys.argv[2]))
    try:
        sys.exit(main())
    except Exception as e:  # any failed phase: report and exit non-zero, no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        left = stop_children()
        if left:
            print(f"chip_smoke: processes left running: {left}", file=sys.stderr)
        sys.exit(1)
