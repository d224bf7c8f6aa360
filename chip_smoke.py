#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`dig_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds every CUDA kernel of the
   predict path from `dig_tpu_torch/ops/csrc/` (one nvcc per source, all
   started together).
2. Holds each kernel against its plain PyTorch version at the predict
   path's shapes (B=512, 256 tokens, width 384, 6 heads x 64), in bf16 and
   fp32, and times the kernel, the plain version and one PyTorch library
   call for the same function (a yardstick the port never calls).
3. Runs the predict path at full width (vit_small_patch4_32x128 +
   tf_decoder, bf16, batch 512, random weights from a seed) on synthetic
   uint8 batches through the entry points a user calls, and asserts from
   the wrappers' launch counts that every batch went through both kernels
   (12 attention and 24 LayerNorm launches per batch).
4. Checks the card's path against the port's CPU path on 8 images in fp32.
5. Prints one JSON line describing every kernel, then as the last line
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
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 FMA pipes
# tolerances, kernel vs plain version on identical inputs: both sum the
# same exact products in fp32 in another order, so fp32 results agree to a
# few ulp; a bf16 output may round to the neighbouring bf16 value (one ulp,
# at most 2^-7 of the value)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=1e-4)}
STAT_TOL = dict(rtol=1e-4, atol=1e-4)  # m and s, fp32 in both dtypes
FEAT_RTOL = 1e-4  # encoder features, card vs CPU, relative to their max |value|
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
    top, busy_ms, wall_ms = profile_batch(torch, predict_fn, x_u8)
    for name, ms in top:
        print(f"[profile] {ms:9.3f} ms  {name[:100]}")
    print(f"[profile] one batch: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on)")
    print(f"[predict] vit_small + tf_decoder bf16 batch {B}: {N_BATCHES} batches in "
          f"{dt:.3f} s = {ips:.1f} images/s on this card; per batch encoder+bridge "
          f"{enc_ms:.2f} ms, greedy decoder {dec_ms:.2f} ms; launches attention {n_attn}, "
          f"layernorm {n_ln}")
    return {"attention_lse_fwd": n_attn, "layer_norm_fwd": n_ln}


def profile_batch(torch, predict_fn, x_u8, n_top=10):
    """Device time by kernel over one predict batch (torch.profiler, CUPTI):
    the top kernels, the device's busy time and the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_fn(x_u8)
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
    _build.build_all(["attention_lse_fwd", "layernorm_fwd"])
    print(f"[build] both kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOGS.items():
        regs = [int(w) for line in log.splitlines() if "Used" in line and "registers" in line
                for w in [line.split("Used")[1].split()[0]]]
        spills = sum("0 bytes spill stores, 0 bytes spill loads" not in line
                     for line in log.splitlines() if "spill" in line)
        print(f"[ptxas {name}] {len(regs)} instantiations, registers {min(regs)}-{max(regs)}, "
              f"{spills} with spills")

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = phase_attention(torch, attn, gen)
    ln_rows = phase_layernorm(torch, ln, gen)
    launches = phase_predict(torch, np, attn, ln)
    phase_cpu_parity(torch, np, attn, ln)

    kernels = [
        dict(name="attention_lse_fwd", route="cuda",
             source="dig_tpu_torch/ops/csrc/attention_lse_fwd.cu",
             replaces="dig_tpu/ops/attention.py:275",
             launches=launches["attention_lse_fwd"], **attn_rows["bfloat16"]),
        dict(name="layer_norm_fwd", route="cuda",
             source="dig_tpu_torch/ops/csrc/layernorm_fwd.cu",
             replaces="dig_tpu/ops/layernorm.py:44",
             launches=launches["layer_norm_fwd"], **ln_rows["bfloat16"]),
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
