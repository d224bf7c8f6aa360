#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`dig_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds every CUDA kernel of
   the port from `dig_tpu_torch/ops/csrc/` (one nvcc per source, all
   started together) and prints each build's ptxas summary.
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
   bound each kernel reaches.
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
   steps, 10 timed; asserts the launches per step of every kernel (24 / 12
   stored-statistics attention forward / backward, 48 / 24 LayerNorm
   forward / backward), a finite loss, a finite gradient on every student
   parameter, and that the parameters and the momentum branch moved.  Then
   the same under the JAX package's opt-in switches
   DIG_TPU_ATTN_STORE_LSE=0 and DIG_TPU_FUSED_BIAS_GRAD=1, with
   DIG_TPU_ATTN_BF16_EXP off and on: 24 / 12 recompute attention forward /
   backward and 14 column sums a step instead.
6. Checks one fp32 pre-training step of the full-width model at batch 2
   on the card against the same step on the CPU, as is and under the
   switches, and profiles one bf16 step.
7. Runs the fine-tuning step (`make_finetune_step`) at the FinetuneConfig
   defaults (vit_small_patch4_32x128 + tf_decoder, bf16, batch 256,
   dropout, attention dropout and drop-path on, label smoothing 0.1, AdamW
   with the CLI's schedules), with DIG_TPU_FUSED_BIAS_GRAD off and on, and
   the eval step (`make_eval_step`, greedy, full length) on one batch of
   256 with each attention pair; asserts their launch counts.
8. Checks one fp32 fine-tuning step of the full-width recognizer (rates 0,
   the column sum on) on the card against the CPU.
9. Drives the pre-training data path and CLI at full width on an LMDB of
   1,024 seeded PNG word images (8 steps an epoch at batch 128): the
   on-device view generator on one batch (exact mask counts, range, and in
   fp32 the card against the CPU under one set of draws); the loader alone
   over one epoch, with host SeqCLR augmentation and without (thread workers,
   and process workers in a child process); `run_pretrain.main` itself for
   two epochs with host augmentation and with `--device_aug` (16 steps, the
   launch counts of item 5 at every step, finite losses in log.txt, both
   checkpoints, parameters moved); and resume equivalence in fp32: two
   epochs straight against one epoch, a fresh `main` that auto-resumes, and
   the second epoch, every parameter, momentum parameter and AdamW moment
   compared bit for bit.
10. Prints one JSON line describing every kernel, then as the last line
   {"ok": true, "device": {...}}.

Exits non-zero, without the result lines, when no CUDA device is visible,
when the package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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
PRE_CLI_RECORDS, PRE_CLI_EPOCHS = 1024, 2  # the pre-training CLI's LMDB: 8 steps an epoch
PRE_CLI_STEPS = PRE_CLI_RECORDS // PRE_BATCH * PRE_CLI_EPOCHS
# the view generator, card vs CPU under the same draws, fp32 images in [-1, 1].
# With the matrices given, the warp's source coordinates are equal to the bit
# on both (they are summed in one fixed order), and the views agree within
# WARP_ATOL.  From the draws, the two devices' cos, sin and tan differ by an
# ulp or two: up to 2e-5 pixels at the image's ends, and up to 4e-5 in a
# bilinear sample of these records, which are noise (neighbours up to 2 apart)
WARP_ATOL, VIEW_ATOL = 1e-5, 1e-4
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
           "layernorm_fwd", "layernorm_bwd", "colsum"]
FT_BATCH = 256
FT_WARMUP, FT_STEPS = 3, 10
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
# the LayerNorm backward's bf16 time before its redesign: one launch of 512
# blocks and two torch sums over its partial rows (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md), printed beside the new one
LN_BWD_FIRST_BODY_MS = 0.0944
# shapes beside the pre-training one: rows that are no multiple of a block's
# 8, fewer rows than the persistent grid has warps, the widest row
LN_BWD_EDGE_SHAPES = ((1000, 384), (512, 1024))
DESIGN = {"attention_lse_fwd": "mma.sync bf16 / FMA fp32", "attention_fwd": "mma.sync bf16 / FMA fp32",
          "attention_lse_bwd": "mma.sync bf16 (dq pass, dk/dv pass) / FMA fp32",
          "attention_bwd": "mma.sync bf16 (dq pass, dk/dv pass) / FMA fp32",
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
    """The bf16 FMA body's time beside the new one, as text."""
    old = FMA_BODY_MS.get(name + key[len("bfloat16"):]) if key.startswith("bfloat16") else None
    return f"; the FMA body took {old:.4f} ms (PERF.md)" if old else ""


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
    top, busy_ms, wall_ms = profile_fn(torch, lambda: predict_fn(x_u8))
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
    # the card divides by the scalar 255 as a product with its reciprocal: one fp32 ulp
    ierr = max_err(on_card["images"].cpu(), on_cpu["images"])
    check(ierr <= 2**-23, f"the original views differ by {ierr}, more than an ulp")
    err = max_err(on_card["aug_images"].cpu(), on_cpu["aug_images"])
    check(err <= VIEW_ATOL, f"augmented view, card vs CPU: max abs err {err} > {VIEW_ATOL}")
    mats = affine_mats(*(params[k] for k in ("angle", "scale", "shear", "tx", "ty")), 32, 128)
    werr = max_err(batched_affine_warp(on_cpu["images"].cuda(), mats.cuda()).cpu(),
                   batched_affine_warp(on_cpu["images"], mats))
    check(werr <= WARP_ATOL, f"the warp, card vs CPU from one set of matrices: {werr} > {WARP_ATOL}")
    gates = {k: int(v.sum()) for k, v in params.items() if k.endswith("_gate")}

    steps = iter(range(1, 1000))
    ms = time_ms(lambda: view_fn(step_generator(1, 1, next(steps), "cuda"), x), iters=20)
    _, busy_ms, wall_ms = profile_fn(torch, lambda: view_fn(step_generator(1, 1, 0, "cuda"), x))
    print(f"[device view] batch {PRE_BATCH}, uint8 -> images, aug_images, mask [{PRE_BATCH}, 2, {L}] "
          f"with {PRE_MASKED} masked a view; {changed} views changed; fp32 card vs CPU under one "
          f"set of draws (gates on: {gates}): max abs err {err:.3e} (atol {VIEW_ATOL}; the "
          f"original view {ierr:.3e}; the warp alone from one set of matrices {werr:.3e}, atol "
          f"{WARP_ATOL}); "
          f"{ms:.3f} ms a batch (CUDA events, 20 batches); one profiled batch: device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall")


LOADER_PROBE = """
import sys, time
import numpy as np
from dig_tpu_torch.data.dataset import build_pretraining_dataset
from dig_tpu_torch.data.pipeline import make_train_loader
db, batch, workers = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
ds = build_pretraining_dataset([db], num_view=2, rng=np.random.default_rng(0))
loader = make_train_loader(ds, local_batch=batch, rank=0, world=1, seed=0, num_workers=workers,
                           worker_type="process")
t0 = time.perf_counter()
n = sum(len(b[0]) for b in loader)
print(n, time.perf_counter() - t0)
"""


def phase_loader(torch, np, db):
    """The loader alone over one epoch of the LMDB: images/s with host
    SeqCLR augmentation and with `num_view=1` (what `--device_aug` reads),
    on 10 worker threads; and with host augmentation on forked process
    workers, measured in a child process that never touches the card."""
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
    probe = subprocess.run([sys.executable, "-c", LOADER_PROBE, db, str(PRE_BATCH), "8"],
                           capture_output=True, text=True, timeout=180, cwd=ROOT,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    check(probe.returncode == 0, f"the process-worker probe failed: {probe.stderr[-2000:]}")
    n, dt = probe.stdout.split()
    check(int(n) == PRE_CLI_RECORDS, f"the process-worker probe read {n} images")
    rates["host aug, 8 process workers"] = PRE_CLI_RECORDS / float(dt)
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


def run_pretrain_cli(torch, tag, argv, steps, cut_after_epoch=None):
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
    check_counts(f"[{tag}]", counts, PER_STEP, steps)
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


def phase_pretrain_data(torch, np, paths):
    """The pre-training data path and CLI on one LMDB in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        db = os.path.join(d, "words")
        write_word_lmdb(np, db, PRE_CLI_RECORDS, 6)
        phase_device_view(torch, np, db)
        phase_loader(torch, np, db)
        paths["pretrain_cli"] = phase_pretrain_cli(
            torch, np, db, os.path.join(d, "host_aug"), "pretrain cli", [])
        paths["pretrain_cli_device_aug"] = phase_pretrain_cli(
            torch, np, db, os.path.join(d, "device_aug"), "pretrain cli device_aug",
            ["--device_aug"])
        phase_pretrain_resume(torch, np, db, d)


def profile_fn(torch, fn, n_top=10):
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI):
    the top kernels, the device's busy time and the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host op's device time repeats its kernels',
    # and so does the optimizer's annotation, which the trace mirrors onto
    # the device's timeline
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[1])
    check(rows, "the profiler saw no device time")
    return rows[:n_top], sum(ms for _, ms in rows), wall_ms


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
              f"dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{bms / ms:.3f} of the bound{fma_body_text('attention_lse_bwd', dn)}")
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


def pretrain_setup(torch, np, dtype, batch, device, seed=0, start_step=0):
    """The port's pre-training entry points as a user calls them: the
    model, AdamW and the step, with the schedules built as
    `dig_tpu/cli/run_pretrain.py:98-110` builds them from the
    `PretrainConfig` defaults (first lr = warmup_lr > 0), the state's step
    counter at `start_step`, and one batch of uint8 views with exact-count
    masks from numpy seed `seed`."""
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
    model = build_pretrain_model(cfg.model, dtype=dtype, seed=seed, device=device,
                                 mlp_dim=cfg.moco_mlp_dim, dim=cfg.moco_dim,
                                 temperature=cfg.moco_t, num_windows=cfg.num_windows,
                                 patchnet_name=cfg.patchnet_name,
                                 label_smoothing=cfg.label_smoothing)
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


def kernel_wrappers():
    from dig_tpu_torch.ops import attention, fused_dense, layernorm

    return {"attention_lse_fwd": attention.attention_lse_fwd,
            "attention_lse_bwd": attention.attention_lse_bwd,
            "attention_fwd": attention.attention_fwd, "attention_bwd": attention.attention_bwd,
            "layer_norm_fwd": layernorm.layer_norm_fwd, "layer_norm_bwd": layernorm.layer_norm_bwd,
            "column_sum": fused_dense.column_sum}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


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
    """Every trainable tensor has a finite gradient and moved from `before`."""
    missing = [n for n, p in model.named_parameters()
               if p.requires_grad and (p.grad is None or not torch.isfinite(p.grad).all())]
    check(not missing, f"{tag}: parameters without a finite gradient: {missing[:8]}")
    moved = [n for n, p in model.named_parameters() if p.requires_grad
             and not torch.equal(p.detach(), before[n])]
    check(len(moved) == len(before), f"{tag}: {len(before) - len(moved)} parameters did not move")
    return len(moved)


def print_profile(torch, tag, fn):
    top, busy_ms, wall_ms = profile_fn(torch, fn)
    for name, ms in top:
        print(f"[profile {tag}] {ms:9.3f} ms  {name[:100]}")
    print(f"[profile {tag}] one step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")


def phase_pretrain(torch, np, tag, want, profile=True):
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
    step_ms = dt / PRE_STEPS * 1e3
    ips = PRE_BATCH * PRE_STEPS / dt
    last = {k: round(float(v), 5) for k, v in metrics.items()}
    print(f"[{tag}] pretrain_simmim_moco_ori_vit_small_patch4_32x128 bf16 batch {PRE_BATCH} "
          f"({n_params / 1e6:.2f} M student params): {PRE_STEPS} steps in {dt:.3f} s = "
          f"{step_ms:.2f} ms/step, {ips:.1f} images/s on this card (per step on the card's "
          f"clock: {step_times_text(step_times)}); launches per step "
          f"{ {k: v // PRE_STEPS for k, v in counts.items()} }; losses "
          f"{[round(x, 5) for x in losses.tolist()]}; last metrics {last}; "
          f"{moved} student and {len(ema_moved)} momentum tensors moved; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
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
    both dtypes: its dq pass takes m and s from the forward's logits, in the
    forward's order."""
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
              f"attention_lse_bwd: {same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
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


def finetune_setup(torch, np, dtype, batch, device, rates=True, seed=0):
    """The port's fine-tuning entry points as a user calls them, at the
    FinetuneConfig defaults: the recognizer (with the CLI's drop rates, or
    every rate 0, the decoder's included, for the card-vs-CPU check),
    AdamW with the schedules built as `dig_tpu/cli/run_finetune.py:311-330`
    builds them (1000 steps an epoch, so the first lr, in the warm-up, is
    above 0), the step, and one batch of uint8 images with labels from
    numpy seed `seed`: random words of 1-24 characters, then EOS, then
    PADDING."""
    from dig_tpu_torch.config import FinetuneConfig
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.optim import create_optimizer, frozen_encoder_mask
    from dig_tpu_torch.train.finetune import init_finetune_state, make_finetune_step
    from dig_tpu_torch.utils.charset import build_charset
    from dig_tpu_torch.utils.schedules import cosine_schedule

    cfg = FinetuneConfig(batch_size=batch).finalize(1)
    steps_per_epoch = 1000
    lr = cosine_schedule(cfg.absolute_lr, cfg.min_lr, cfg.epochs, steps_per_epoch,
                         warmup_epochs=cfg.warmup_epochs, start_warmup_value=cfg.warmup_lr,
                         warmup_steps=cfg.warmup_steps)
    wd = cosine_schedule(cfg.weight_decay, cfg.weight_decay_end, cfg.epochs, steps_per_epoch)
    check(lr[0] > 0, "the first step's lr must be above 0")
    charset = build_charset(cfg.voc_type, cfg.max_len)
    check(charset.num_classes == cfg.nb_classes, "charset and nb_classes disagree")
    r = 1.0 if rates else 0.0
    model = build_rec_model(cfg.model, cfg.decoder_name, cfg.nb_classes, cfg.max_len,
                            drop_rate=r * cfg.drop, attn_drop_rate=r * cfg.attn_drop_rate,
                            drop_path_rate=r * cfg.drop_path, use_1d_attdec=cfg.use_1d_attdec,
                            use_mean_pooling=cfg.use_mean_pooling, dtype=dtype,
                            model_kind=cfg.model_kind, seed=seed, device=device)
    if not rates:  # the decoder's dropout too (its modules read the rate at every call)
        for m in model.decoder.modules():
            if hasattr(m, "dropout"):
                m.dropout = 0.0
    frozen = (frozen_encoder_mask(cfg.fixed_encoder_layers) if cfg.fixed_encoder_layers > 0
              else None)
    opt = create_optimizer(cfg.opt, model.named_parameters(), lr, wd, betas=cfg.opt_betas,
                           eps=cfg.opt_eps, clip_grad=cfg.clip_grad, layer_decay=cfg.layer_decay,
                           num_layers=model.encoder.depth, frozen=frozen,
                           update_freq=cfg.update_freq)
    state = init_finetune_state(model, opt)
    step = make_finetune_step(model, cfg.smoothing)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, cfg.max_len + 1, batch)  # characters + EOS
    targets = np.full((batch, cfg.max_len), charset.padding_id, np.int64)
    for i, n in enumerate(lengths):
        targets[i, :n - 1] = rng.integers(0, charset.eos_id, n - 1)
        targets[i, n - 1] = charset.eos_id
    batch_np = {"images": rng.integers(0, 256, (batch, 32, 128, 3), dtype=np.uint8),
                "targets": targets, "lengths": lengths}
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


FWD_MODES = ("kStats", "kPlain", "kBf16Exp")
BWD_MODES = ("stored statistics", "kRecompute")


# an attention body's mangled name -> its template arguments as text
PTXAS_NAMES = [
    (r"(attn_fwd_(?:mma|fma)_kernel)ILi(\d+)ELNS_7FwdModeE(\d)E",
     lambda m: f"{m[1]}<D={m[2]}, {FWD_MODES[int(m[3])]}>"),
    (r"(attn_bwd_dq_mma_kernel)ILi(\d+)ELb([01])E",
     lambda m: f"{m[1]}<D={m[2]}, {BWD_MODES[int(m[3])]}>"),
    (r"(attn_bwd_dkdv_mma_kernel)ILi(\d+)E", lambda m: f"{m[1]}<D={m[2]}>"),
    (r"(attn_bwd_dq_kernel)ILi(\d+)ELb([01])E",
     lambda m: f"{m[1]}<D={m[2]}, {BWD_MODES[int(m[3])]}>"),
    (r"(attn_bwd_dkdv_kernel)ILi(\d+)E", lambda m: f"{m[1]}<D={m[2]}>"),
]
def ptxas_kernels(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of one
    build's ptxas report, an attention body's name as
    attn_fwd_mma_kernel<D=64, kStats>."""
    kernels, name, spills = [], "", (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            for pattern, text in PTXAS_NAMES:
                m = re.search(pattern, name)
                if m:
                    name = text(m)
                    break
            else:
                name = name[name.find("attn") if "attn" in name else 0:][:60]
        elif "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = (int(m[1]), int(m[2]))
        elif "Used" in line and "registers" in line:
            kernels.append((name, int(line.split("Used")[1].split()[0]), *spills))
    return kernels


# the tensor-core instantiations at the model's head_dim, by source
MMA_D64 = {"attention_lse_fwd": ["attn_fwd_mma_kernel<D=64, kStats>"],
           "attention_fwd": ["attn_fwd_mma_kernel<D=64, kPlain>",
                             "attn_fwd_mma_kernel<D=64, kBf16Exp>"],
           "attention_lse_bwd": ["attn_bwd_dq_mma_kernel<D=64, stored statistics>",
                                 "attn_bwd_dkdv_mma_kernel<D=64>"],
           "attention_bwd": ["attn_bwd_dq_mma_kernel<D=64, kRecompute>",
                             "attn_bwd_dkdv_mma_kernel<D=64>"]}


def print_ptxas():
    """Each build's registers, shared memory and spills; every attention
    instantiation by name.  Fails if a source has no report, if a bf16
    (tensor-core) attention body at D=64, the model's head_dim, forward or
    backward, is missing from its source's report, or if it spills."""
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
        for k in MMA_D64.get(name, []):
            check(k in found, f"{k} is not in the ptxas report of {name}")
            check(found[k] == 0, f"{k} spills")


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

    _build.build_all(SOURCES)
    print(f"[build] {len(SOURCES)} kernels in {time.perf_counter() - t_start:.1f} s")
    print_ptxas()

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = phase_attention(torch, attn, gen)
    ln_rows = phase_layernorm(torch, ln, gen)
    attn_bwd_rows = phase_attention_bwd(torch, attn, gen)
    ln_bwd_rows = phase_layernorm_bwd(torch, ln, gen)
    rec_rows = phase_attention_recompute(torch, attn, gen)
    rec_bwd_rows = phase_attention_bwd_recompute(torch, attn, gen)
    colsum_row = phase_colsum(torch, fd, gen)

    paths = {"predict": phase_predict(torch, np)}
    phase_host_images(np)
    paths["predict_cli"] = phase_predict_cli(torch, np)
    phase_cpu_parity(torch, np)
    paths["pretrain"] = phase_pretrain(torch, np, "pretrain", PER_STEP)
    phase_pretrain_cpu_parity(torch, np, "pretrain cpu parity", PER_STEP)
    with switches(store_lse=False, fused_bias_grad=True):
        paths["pretrain_switches"] = phase_pretrain(torch, np, "pretrain switches",
                                                    PER_STEP_SWITCHES)
        with switches(store_lse=False, fused_bias_grad=True, bf16_exp=True):
            phase_pretrain(torch, np, "pretrain switches bf16_exp", PER_STEP_SWITCHES,
                           profile=False)
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
    phase_pretrain_data(torch, np, paths)

    def row(name, source, replaces, measured, path):
        return dict(name=name, route="cuda", source=f"dig_tpu_torch/ops/csrc/{source}.cu",
                    replaces=replaces, launches=paths[path][name],
                    launches_by_path={p: c[name] for p, c in paths.items()}, design=DESIGN[name],
                    bound_share=measured["bound_ms"] / measured["ms"], **measured)

    kernels = [
        row("attention_fwd", "attention_fwd", "dig_tpu/ops/attention.py:65",
            dict(rec_rows["bfloat16"], bf16_exp=rec_rows["bfloat16_bf16_exp"],
                 float32=rec_rows["float32"]),
            "pretrain_switches"),
        row("attention_bwd", "attention_bwd", "dig_tpu/ops/attention.py:111",
            rec_bwd_rows["bfloat16"], "pretrain_switches"),
        row("attention_lse_fwd", "attention_lse_fwd", "dig_tpu/ops/attention.py:275",
            dict(attn_rows["bfloat16"], float32=attn_rows["float32"]), "pretrain"),
        row("attention_lse_bwd", "attention_lse_bwd", "dig_tpu/ops/attention.py:299",
            attn_bwd_rows["bfloat16"], "pretrain"),
        row("layer_norm_fwd", "layernorm_fwd", "dig_tpu/ops/layernorm.py:44", ln_rows["bfloat16"],
            "pretrain"),
        row("layer_norm_bwd", "layernorm_bwd", "dig_tpu/ops/layernorm.py:54",
            ln_bwd_rows["bfloat16"], "pretrain"),
        row("column_sum", "colsum", "dig_tpu/ops/fused_dense.py:37", colsum_row,
            "pretrain_switches"),
    ]
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # any failed phase: report and exit non-zero, no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
