#!/usr/bin/env python3
"""Time the port's LayerNorm backward (`layer_norm_bwd`) on the card.

    python3 tools/time_layernorm_bwd.py [package root ...]

For each root (a directory that holds a `dig_tpu_torch` package; default:
this repository), builds `layernorm_bwd` from that root's
`dig_tpu_torch/ops/csrc/`, prints its ptxas lines and grid size, checks the
wrapper against `_ln_bwd_ref` at the pre-training shape (65,536 x 384) and
three other shapes (ragged rows, the widest and the narrowest row) in bf16
and fp32, checks that two calls give the same bits, and times the wrapper
with CUDA events: rounds of 200 launches, the roots taking turns inside
each round so that two bodies are compared on one
card in one call.  Also prints the host time of one call (enqueue only)
and the device time of each kernel a call launches (torch.profiler).  To
compare a tuning constant of `layernorm_bwd.cu`, or the body of an earlier
commit, give a copy of the package with that source as a further root.
Needs a CUDA device.
"""

import importlib
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, C = 65536, 384
EDGE_SHAPES = ((1000, 384), (512, 1024), (65536, 128))
ROUNDS, ITERS = 5, 200
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def load_layernorm(root):
    """`dig_tpu_torch.ops.layernorm` of the package under `root`, imported
    afresh (any earlier root's modules dropped first)."""
    for name in [m for m in sys.modules if m == "dig_tpu_torch" or m.startswith("dig_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        ln = importlib.import_module("dig_tpu_torch.ops.layernorm")
        build = importlib.import_module("dig_tpu_torch.ops._build")
    finally:
        sys.path.remove(root)
    return ln, build


def time_ms(fn, iters):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(rows, c, dtype, gen):
    x = (2 * torch.randn(rows, c, generator=gen, device="cuda") + 0.5).to(dtype)
    dy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
    g = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, g, dy


def check(tag, ln, rows, c, dtype, gen):
    x, g, dy = inputs(rows, c, dtype, gen)
    got = ln.layer_norm_bwd(x, g, dy, 1e-6)
    again = ln.layer_norm_bwd(x, g, dy, 1e-6)
    torch.cuda.synchronize()
    ref = ln._ln_bwd_ref(x, g, dy, 1e-6)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip(got, ref)]
    tol = (2**-7 if dtype == torch.bfloat16 else 1e-5, 1e-5, 1e-5)
    ok = same and all(e <= t for e, t in zip(errs, tol))
    print(f"[{tag}] {rows} x {c} {str(dtype).split('.')[1]}: max err / max |ref| dx {errs[0]:.2e} "
          f"dgamma {errs[1]:.2e} dbeta {errs[2]:.2e}; run to run equal: {same}; "
          f"{'ok' if ok else 'FAILED'}")
    return ok


def main():
    if not torch.cuda.is_available():
        print("time_layernorm_bwd: no CUDA device visible", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [HERE]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns, ok = {}, True
    for root in roots:
        tag = os.path.relpath(root, HERE)
        ln, build = load_layernorm(root)
        try:
            build.build_all(["layernorm_bwd"])
        except RuntimeError as e:  # a root that does not build is reported and left out
            print(f"[build {tag}] FAILED:\n{str(e)[-3000:]}")
            ok = False
            continue
        name = ""
        for line in build.build_log("layernorm_bwd").splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif ("Li3E" in name or "finish" in name) and ("Used" in line or "spill" in line):
                print(f"[ptxas {tag}] {name[-40:]} {line.strip()}")
        try:
            for dtype in (torch.bfloat16, torch.float32):
                ok &= check(tag, ln, ROWS, C, dtype, gen)
                for rows, c in EDGE_SHAPES:
                    ok &= check(tag, ln, rows, c, dtype, gen)
        except RuntimeError as e:  # a launch that is refused: reported, the root left out
            print(f"[check {tag}] FAILED: {e}")
            ok = False
            continue
        fns[tag] = ln.layer_norm_bwd
        if hasattr(ln, "_bwd_blocks"):  # a body with a persistent grid says its size
            grid = {str(dt).split(".")[1]: ln._bwd_blocks(0, code, ROWS, C)
                    for dt, code in ln._DTYPES.items()}
            print(f"[grid {tag}] {ROWS} x {C}: blocks = partial rows {grid} on "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        x, g, dy = inputs(ROWS, C, dtype, gen)
        bound_ms = (3 * ROWS * C * x.element_size() + 3 * C * 4) / PEAK_BYTES_PER_S * 1e3
        times = {tag: [] for tag in fns}
        for r in range(ROUNDS):
            order = list(fns) if r % 2 == 0 else list(fns)[::-1]
            for tag in order:
                times[tag].append(time_ms(lambda: fns[tag](x, g, dy, 1e-6), ITERS))
        for tag, ts in times.items():
            med = sorted(ts)[len(ts) // 2]
            print(f"[time {tag}] {ROWS} x {C} {dn}: median {med:.4f} ms of "
                  f"{[round(t, 4) for t in ts]}; bound {bound_ms:.4f} ms, {bound_ms / med:.3f} of it")
        if dtype == torch.bfloat16:
            from torch.profiler import ProfilerActivity, profile

            for tag, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ITERS):
                    fn(x, g, dy, 1e-6)
                host_us = (time.perf_counter() - t0) / ITERS * 1e6
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        fn(x, g, dy, 1e-6)
                    torch.cuda.synchronize()
                parts = ", ".join(f"{e.key[:48]} {e.self_device_time_total / e.count / 1e3:.4f} ms "
                                  f"x {e.count}" for e in prof.key_averages()
                                  if e.self_device_time_total > 0)
                print(f"[call {tag}] host {host_us:.1f} us a call (enqueue); kernels: {parts}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
