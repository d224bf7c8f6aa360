#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`dig_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds every CUDA kernel of
   the port from `dig_tpu_torch/ops/csrc/` (one nvcc per source, all
   started together) and prints each build's ptxas summary.
2. Holds each forward kernel against its plain PyTorch version at the
   predict path's shapes (B=512, 256 tokens, width 384, 6 heads x 64), and
   each backward kernel at the pre-training step's shapes (B=256 sequences:
   2 views x 128 images; LayerNorm rows 65,536 x 384), in bf16 and fp32,
   and times the kernel, the plain version and one PyTorch library call
   for the same function (a yardstick the port never calls).
3. Runs the predict path at full width (vit_small_patch4_32x128 +
   tf_decoder, bf16, batch 512, random weights from a seed) on synthetic
   uint8 batches through the entry points a user calls, and asserts from
   the wrappers' launch counts that every batch went through both forward
   kernels (12 attention and 24 LayerNorm launches per batch).
4. Checks the card's predict path against the port's CPU path on 8 images
   in fp32.
5. Runs the pre-training step (`make_pretrain_step`) at full width
   (pretrain_simmim_moco_ori_vit_small_patch4_32x128, bf16, batch 128,
   random weights from a seed, the CLI's default schedules): 3 warm-up
   steps, 10 timed; asserts 24 / 12 / 48 / 24 launches per step of the
   attention forward / backward and LayerNorm forward / backward kernels,
   a finite loss, a finite gradient on every student parameter, and that
   the parameters and the momentum branch moved.
6. Checks one fp32 pre-training step of the full-width model at batch 2
   on the card against the same step on the CPU, and profiles one bf16
   step.
7. Prints one JSON line describing every kernel, then as the last line
   {"ok": true, "device": {...}}.

Exits non-zero, without the result lines, when no CUDA device is visible,
when the package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

B, L, H, D = 512, 256, 6, 64
C = H * D
N_BATCHES = 4
PRE_BATCH = 128            # images per pre-training step; 2 views -> 256 sequences
PRE_B = 2 * PRE_BATCH
PRE_WARMUP, PRE_STEPS = 3, 10
PRE_MASKED = 179           # exact-count SimMIM masks: 179 of 256 patches per view
PER_STEP = {"attention_lse_fwd": 24, "attention_lse_bwd": 12,
            "layer_norm_fwd": 48, "layer_norm_bwd": 24}
SOURCES = ["attention_lse_fwd", "attention_lse_bwd", "layernorm_fwd", "layernorm_bwd"]
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 FMA pipes
# tolerances, kernel vs plain version on identical inputs: both sum the
# same exact products in fp32 in another order, so fp32 results agree to a
# few ulp; a bf16 output may round to the neighbouring bf16 value (one ulp,
# at most 2^-7 of the value)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=1e-4)}
STAT_TOL = dict(rtol=1e-4, atol=1e-4)  # m and s, fp32 in both dtypes
# backward kernels vs plain versions, relative to each gradient's max |value|:
# in fp32 the same products in another order; in bf16 an intermediate the
# TPU kernel rounds to bf16 (ds0, the scaled q and do) may round the other
# way after an fp32 ulp of difference, moving a sum of many terms by a
# fraction of one term
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


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, ref, tol):
    import torch

    err = max_err(got, ref)
    check(torch.allclose(got.float(), ref.float(), **tol), f"{name}: max abs err {err} beyond {tol}")
    return err


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
        err = check_close(f"attention {dn} o", o, ro, TOL[dn])
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
        print(f"[attention_lse_fwd {dn}] max_abs_err o={err:.3e} m,s ok; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
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


def phase_predict(torch, np, attn, ln):
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

    attn.attention_lse_fwd.launches = 0
    ln.layer_norm_fwd.launches = 0
    t0 = time.perf_counter()
    results = list(predict_batches(predict_fn, batches[1:], B, "cuda"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_attn, n_ln = attn.attention_lse_fwd.launches, ln.layer_norm_fwd.launches
    check(n_attn == 12 * N_BATCHES, f"attention launches {n_attn} != {12 * N_BATCHES}")
    check(n_ln == 24 * N_BATCHES, f"layernorm launches {n_ln} != {24 * N_BATCHES}")
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
    return {"attention_lse_fwd": n_attn, "layer_norm_fwd": n_ln}


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
    # device-side events only: a host op's device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    check(rows, "the profiler saw no device time")
    return rows[:n_top], sum(ms for _, ms in rows), wall_ms


def phase_cpu_parity(torch, np, attn, ln):
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.ops.images import to_model_images

    kw = dict(dtype=torch.float32, seed=1)
    m_cpu = build_rec_model("vit_small_patch4_32x128", "tf_decoder", 97, 25, device="cpu", **kw)
    m_gpu = build_rec_model("vit_small_patch4_32x128", "tf_decoder", 97, 25, device="cuda", **kw)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (8, 32, 128, 3), dtype=np.uint8))
    attn.attention_lse_fwd.launches = 0
    ln.layer_norm_fwd.launches = 0
    with torch.no_grad():
        f_cpu = m_cpu.encoder(to_model_images(x))
        f_gpu = m_gpu.encoder(to_model_images(x.cuda())).cpu()
        check(attn.attention_lse_fwd.launches == 12 and ln.layer_norm_fwd.launches == 24,
              "the fp32 card path did not go through both kernels")
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
              f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del qkv, q, k, v, do, m, s, dqkv, out, qt, kt, vt, o, dot
        torch.cuda.empty_cache()
    return rows


def phase_layernorm_bwd(torch, ln, gen):
    rows = {}
    eps = 1e-6
    r = PRE_B * L
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        x = (2 * torch.randn(r, C, generator=gen, device="cuda") + 0.5).to(dt)
        dy = torch.randn(r, C, generator=gen, device="cuda").to(dt)
        g = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        dx, dg, db = ln.layer_norm_bwd(x, g, dy, eps)
        torch.cuda.synchronize()
        rdx, rdg, rdb = ln._ln_bwd_ref(x, g, dy, eps)
        err = check_close(f"layer_norm_bwd {dn} dx", dx, rdx, TOL[dn])
        for name, got, ref in (("dgamma", dg, rdg), ("dbeta", db, rdb)):
            rel = rel_err(got, ref)
            check(rel <= BWD_RTOL["float32"], f"layer_norm_bwd {dn} {name}: {rel:.2e} of max |ref|")
        gerr = max(max_err(dg, rdg), max_err(db, rdb))
        ms = time_ms(lambda: ln.layer_norm_bwd(x, g, dy, eps), iters=50)
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
        print(f"[layer_norm_bwd {dn}] rows={r} c={C}: max_abs_err dx={err:.3e} "
              f"dgamma,dbeta={gerr:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.layer_norm backward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del x, dy, dx, rdx, xl, y
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


def reset_counts(attn, ln):
    for fn in (attn.attention_lse_fwd, attn.attention_lse_bwd, ln.layer_norm_fwd,
               ln.layer_norm_bwd):
        fn.launches = 0


def read_counts(attn, ln):
    return {"attention_lse_fwd": attn.attention_lse_fwd.launches,
            "attention_lse_bwd": attn.attention_lse_bwd.launches,
            "layer_norm_fwd": ln.layer_norm_fwd.launches,
            "layer_norm_bwd": ln.layer_norm_bwd.launches}


def phase_pretrain(torch, np, attn, ln):
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

    reset_counts(attn, ln)
    losses = []
    # events between steps time each step on the card's timeline without a host wait
    events = [torch.cuda.Event(enable_timing=True) for _ in range(PRE_STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(PRE_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    srt = sorted(step_times)
    counts = read_counts(attn, ln)
    for name, per_step in PER_STEP.items():
        check(counts[name] == per_step * PRE_STEPS,
              f"{name}: {counts[name]} launches in {PRE_STEPS} steps, want {per_step} a step")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}")
    missing = [n for n, p in model.named_parameters()
               if p.requires_grad and (p.grad is None or not torch.isfinite(p.grad).all())]
    check(not missing, f"student parameters without a finite gradient: {missing[:8]}")
    moved = [n for n, p in model.named_parameters() if p.requires_grad
             and not torch.equal(p.detach(), student[n])]
    check(len(moved) == len(student), f"{len(student) - len(moved)} student parameters did not move")
    ema_moved = [n for n, p in model.named_parameters() if not p.requires_grad
                 and not torch.equal(p.detach(), momentum[n])]
    check(len(ema_moved) == len(momentum),
          f"{len(momentum) - len(ema_moved)} momentum parameters did not move")
    step_ms = dt / PRE_STEPS * 1e3
    ips = PRE_BATCH * PRE_STEPS / dt
    last = {k: round(float(v), 5) for k, v in metrics.items()}
    print(f"[pretrain] pretrain_simmim_moco_ori_vit_small_patch4_32x128 bf16 batch {PRE_BATCH} "
          f"({n_params / 1e6:.2f} M student params): {PRE_STEPS} steps in {dt:.3f} s = "
          f"{step_ms:.2f} ms/step, {ips:.1f} images/s on this card (per step on the card's "
          f"clock: median {srt[len(srt) // 2]:.2f} ms, min {srt[0]:.2f}, max {srt[-1]:.2f}, "
          f"in order {[round(t, 2) for t in step_times]}); launches per step "
          f"{ {k: v // PRE_STEPS for k, v in counts.items()} }; losses "
          f"{[round(x, 5) for x in losses.tolist()]}; last metrics {last}; "
          f"{len(moved)} student and {len(ema_moved)} momentum tensors moved; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    top, busy_ms, wall_ms = profile_fn(torch, lambda: step(state, batch))
    for name, ms in top:
        print(f"[profile pretrain] {ms:9.3f} ms  {name[:100]}")
    print(f"[profile pretrain] one step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")
    del model, state, batch, student, momentum
    torch.cuda.empty_cache()
    return counts


def phase_pretrain_cpu_parity(torch, np, attn, ln):
    """One fp32 step of the full-width model at batch 2, card vs CPU, from
    identical weights, schedules and inputs; at the step where the
    contrast weight has ramped up (0 at step 0), so both losses reach
    every gradient."""
    runs = {}
    for device in ("cpu", "cuda"):
        model, state, step, batch_np = pretrain_setup(torch, np, torch.float32, 2, device, seed=1,
                                                      start_step=500)
        reset_counts(attn, ln)
        state, metrics = step(state, batch_np)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_counts(attn, ln)
            check(counts == PER_STEP, f"the fp32 card step's launches {counts} != {PER_STEP}")
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.requires_grad}
        runs[device] = (float(metrics["loss"]), grads)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    check(abs(l_cpu - l_gpu) <= STEP_RTOL * abs(l_cpu), f"loss {l_gpu} on the card vs {l_cpu}")
    floor = STEP_FLOOR * max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for name, g in g_cpu.items():
        err = float((g_gpu[name] - g).abs().max())
        scale = float(g.abs().max())
        check(err <= STEP_RTOL * scale + floor,
              f"gradient {name}: card vs CPU max abs err {err} (max |g| {scale})")
        if err / max(scale, 1e-30) > worst and scale > floor:
            worst, worst_name = err / scale, name
    print(f"[pretrain cpu parity] fp32 batch 2, full width: loss {l_gpu:.7f} (card) vs "
          f"{l_cpu:.7f} (cpu); {len(g_cpu)} gradient leaves within {STEP_RTOL} of their max "
          f"|g|; worst {worst:.2e} ({worst_name}); kernels launched {PER_STEP}")


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

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"[build] {len(SOURCES)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        if name not in _build.BUILD_LOGS:
            print(f"[ptxas {name}] library already built; no report")
            continue
        log = _build.BUILD_LOGS[name]
        regs = [int(w) for line in log.splitlines() if "Used" in line and "registers" in line
                for w in [line.split("Used")[1].split()[0]]]
        smem = sorted({int(line.split("bytes smem")[0].split()[-1])
                       for line in log.splitlines() if "bytes smem" in line})
        spills = sum("0 bytes spill stores, 0 bytes spill loads" not in line
                     for line in log.splitlines() if "spill" in line)
        check(regs, f"no ptxas report for {name}")
        print(f"[ptxas {name}] {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"static smem bytes {smem or [0]}, {spills} with spills")

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = phase_attention(torch, attn, gen)
    ln_rows = phase_layernorm(torch, ln, gen)
    attn_bwd_rows = phase_attention_bwd(torch, attn, gen)
    ln_bwd_rows = phase_layernorm_bwd(torch, ln, gen)
    predict_counts = phase_predict(torch, np, attn, ln)
    phase_cpu_parity(torch, np, attn, ln)
    pretrain_counts = phase_pretrain(torch, np, attn, ln)
    phase_pretrain_cpu_parity(torch, np, attn, ln)

    def row(name, source, replaces, measured):
        return dict(name=name, route="cuda", source=f"dig_tpu_torch/ops/csrc/{source}.cu",
                    replaces=replaces, launches=pretrain_counts[name],
                    launches_by_path={"predict": predict_counts.get(name, 0),
                                      "pretrain": pretrain_counts[name]},
                    **measured["bfloat16"])

    kernels = [
        row("attention_lse_fwd", "attention_lse_fwd", "dig_tpu/ops/attention.py:275", attn_rows),
        row("attention_lse_bwd", "attention_lse_bwd", "dig_tpu/ops/attention.py:299",
            attn_bwd_rows),
        row("layer_norm_fwd", "layernorm_fwd", "dig_tpu/ops/layernorm.py:44", ln_rows),
        row("layer_norm_bwd", "layernorm_bwd", "dig_tpu/ops/layernorm.py:54", ln_bwd_rows),
    ]
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
