#!/usr/bin/env python3
"""Check and time the port's bf16 attention forward kernels on the card.

    python3 tools/time_attention_fwd.py [package root ...]

For each root (a directory that holds a `dig_tpu_torch` package; default:
this repository), builds the four attention sources from that root's
`dig_tpu_torch/ops/csrc/`, prints the ptxas lines of the bf16 forward
bodies, and checks #3 (`attention_lse_fwd`) and #1 (`attention_fwd`, both
modes) against their plain versions at chip_smoke.py's tolerances on the
path's shapes and at ragged edges, #1's o against #3's bit for bit and #2
(`attention_bwd`) against #4 (`attention_lse_bwd`) bit for bit.  A root
that has `csrc/attention_probe.cu` also reports whether the wgmma logits
of the same bf16 q and k agree bit for bit with the mma.sync logits and,
where its probe has them, with the backward's operand forms.  Then times
#3, #1 and SDPA (a yardstick) with CUDA events at the path's shapes:
rounds of 30 launches, the roots taking turns inside each round, so that
two bodies (this tree and a copy of an earlier commit's package, or a copy
with a constant of `attention_fwd.cuh` edited) are compared on one card in
one call.  Needs a CUDA device.
"""

import ctypes
import importlib
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ["attention_lse_fwd", "attention_fwd", "attention_lse_bwd", "attention_bwd"]
# (name, B, L, H, D): the predict batch, the pre-training step, the
# sequence-class encoder (L = 281: 5 key tiles, a ragged last one) and the
# pre-training step on one tensor rank's heads
TIMED = [("predict", 512, 256, 6, 64), ("pretrain", 256, 256, 6, 64),
         ("seq-cls", 256, 281, 12, 64), ("tensor split", 256, 256, 3, 64)]
# (B, Lq, Lk, H, D) checked only: ragged query blocks and key tiles, the
# other head_dims, the longest Lk the wrapper takes at D = 64
EDGES = [(3, 200, 130, 2, 32), (2, 128, 320, 4, 128), (2, 77, 130, 3, 64), (1, 128, 776, 2, 64),
         (3, 50, 40, 2, 64)]
ROUNDS, ITERS = 3, 30
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# chip_smoke.py's tolerances for the bf16 forward's o
TOL = dict(rtol=2**-7, atol=1e-4)
BF16_EXP_TOL = dict(rtol=2**-7, atol=2**-8)
STAT_TOL = dict(rtol=1e-4, atol=1e-4)
FLIP_SHARE = 1e-4


def load_attention(root):
    """`dig_tpu_torch.ops.attention` and `_build` of the package under
    `root`, imported afresh (any earlier root's modules dropped first)."""
    for name in [m for m in sys.modules if m == "dig_tpu_torch" or m.startswith("dig_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        attn = importlib.import_module("dig_tpu_torch.ops.attention")
        build = importlib.import_module("dig_tpu_torch.ops._build")
    finally:
        sys.path.remove(root)
    return attn, build


def time_ms(fn, iters=ITERS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(b, lq, lk, h, d, gen):
    """q, k, v as head-split column slices of packed [B, L, 3 H D] bf16
    projections, and do."""
    c = h * d
    q = torch.randn(b, lq, 3 * c, generator=gen, device="cuda").bfloat16()[..., :c]
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").bfloat16()
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    do = torch.randn(b, lq, h, d, generator=gen, device="cuda").bfloat16()
    return q.view(b, lq, h, d), k, v, do


def outside(got, ref, tol):
    diff = (got.float() - ref.float()).abs()
    return int((diff > tol["atol"] + tol["rtol"] * ref.float().abs()).sum())


def check(tag, attn, shape, gen):
    """#3, #1 (both modes), #2 == #4 at one shape; True if all hold."""
    b, lq, lk, h, d = shape
    q, k, v, do = inputs(b, lq, lk, h, d, gen)
    scale = d**-0.5
    o, m, s = attn.attention_lse_fwd(q, k, v, scale)
    ro, rm, rs = attn.attention_lse_fwd_ref(q, k, v, scale)
    n_out = outside(o, ro, TOL)
    ok = (outside(o, ro, BF16_EXP_TOL) == 0 and n_out <= math.ceil(FLIP_SHARE * o.numel())
          and outside(m, rm, STAT_TOL) == 0 and outside(s, rs, STAT_TOL) == 0)
    attn.BF16_EXP = False
    o1 = attn.attention_fwd(q, k, v, scale)
    same = bool(torch.equal(o1, o))
    attn.BF16_EXP = True
    try:
        oe = attn.attention_fwd(q, k, v, scale)
        re = attn.attention_fwd_ref(q, k, v, scale)
    finally:
        attn.BF16_EXP = False
    exp_ok = outside(oe, re, BF16_EXP_TOL) == 0
    bwd_same = True  # the backward's Lk limit is lower than the forward's
    if attn._fits(d, lk):
        lse = attn.attention_lse_bwd(q, k, v, do, m, s, scale)
        rec = attn.attention_bwd(q, k, v, do, scale)
        bwd_same = all(bool(torch.equal(x, y)) for x, y in zip(lse, rec))
    torch.cuda.synchronize()
    ok = ok and same and exp_ok and bwd_same
    print(f"[check {tag}] B={b} Lq={lq} Lk={lk} H={h} D={d}: #3 o max err "
          f"{float((o.float() - ro.float()).abs().max()):.3e}, {n_out} of {o.numel()} outside "
          f"TOL; m, s {'ok' if outside(m, rm, STAT_TOL) + outside(s, rs, STAT_TOL) == 0 else 'OFF'};"
          f" #1 o equal to #3's: {same}; #1 bf16-exp within its tolerance: {exp_ok}; #2 equal "
          f"to #4: {bwd_same}; {'ok' if ok else 'FAILED'}")
    return ok


def probe(tag, build, gen):
    """The forward's wgmma logits against the other forms' (the mma.sync
    logits, and where the root's probe has them the backward's row and
    column pass forms) of the same bf16 q, k: {form: elements that
    differ}, or None without a probe."""
    if not os.path.exists(os.path.join(os.path.dirname(build.__file__), "csrc",
                                       "attention_probe.cu")):
        return None
    lib = build.load("attention_probe")
    forms = hasattr(lib, "dig_attn_logits_forms")
    fn = lib.dig_attn_logits_forms if forms else lib.dig_attn_logits_probe
    n_out = 4 if forms else 2
    fn.argtypes = [ctypes.c_void_p] * (2 + n_out) + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 4096
    q, k = (torch.randn(n, 64, 64, generator=gen, device="cuda").bfloat16() for _ in range(2))
    outs = [torch.empty(n, 64, 64, device="cuda") for _ in range(n_out)]
    qscale = torch.tensor(64**-0.5 * 1.4426950408889634, dtype=torch.bfloat16).item()
    build.check(lib, fn(q.data_ptr(), k.data_ptr(), *(o.data_ptr() for o in outs), n, qscale,
                        build.stream_ptr(q)), "attention probe")
    torch.cuda.synchronize()
    fwd = outs[0].view(torch.int32)
    differ = {}
    for name, o in zip(("mma.sync", "bwd rows", "bwd columns"), outs[1:]):
        bits = o.view(torch.int32)
        differ[name] = int((bits != fwd).sum())
        print(f"[probe {tag}] wgmma vs {name} logits of {fwd.numel()} (q, k) pairs at D=64: "
              f"{differ[name]} differ ({differ[name] / fwd.numel():.3e} of them), at most "
              f"{int((bits - fwd).abs().max())} ulp apart")
    return differ


def main():
    if not torch.cuda.is_available():
        print("time_attention_fwd: no CUDA device visible", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [HERE]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    mods, ok = {}, True
    for root in roots:
        tag = os.path.relpath(root, HERE)
        attn, build = load_attention(root)
        try:
            build.build_all(SOURCES)
        except RuntimeError as e:  # a root that does not build is reported and left out
            print(f"[build {tag}] FAILED:\n{str(e)[-6000:]}")
            ok = False
            continue
        for source in SOURCES[:2]:
            name = ""
            for line in build.build_log(source).splitlines():
                if "Compiling entry function" in line:
                    name = line.split("'")[1]
                elif "attn_fwd_" in name and "Li64E" in name and ("Used" in line or "spill" in line
                                                                  or "warning" in line):
                    print(f"[ptxas {tag} {source}] {name[name.find('attn'):][:60]} {line.strip()}")
            for line in build.build_log(source).splitlines():
                if "warning" in line.lower() or "(C75" in line:  # C75xx: wgmma serialised
                    print(f"[ptxas {tag} {source}] {line.strip()[:240]}")
        try:
            probe(tag, build, gen)
            for name, b, l, h, d in TIMED:
                ok &= check(f"{tag} {name}", attn, (b, l, l, h, d), gen)
            for shape in EDGES:
                ok &= check(f"{tag} edge", attn, shape, gen)
        except RuntimeError as e:  # a launch that fails: reported, the root left out
            print(f"[check {tag}] FAILED: {e}")
            ok = False
            continue
        mods[tag] = attn
    for name, b, l, h, d in TIMED:
        q, k, v, _ = inputs(b, l, l, h, d, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        scale = d**-0.5
        nbytes = 4 * b * l * h * d * 2 + 2 * b * l * h * 4
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        times = {}
        for r in range(ROUNDS):
            order = list(mods) if r % 2 == 0 else list(mods)[::-1]
            for tag in order:
                attn = mods[tag]
                times.setdefault((tag, "#3"), []).append(
                    time_ms(lambda: attn.attention_lse_fwd(q, k, v, scale)))
                times.setdefault((tag, "#1"), []).append(
                    time_ms(lambda: attn.attention_fwd(q, k, v, scale)))
            times.setdefault(("", "sdpa"), []).append(
                time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)))
        for (tag, what), ts in times.items():
            med = sorted(ts)[len(ts) // 2]
            print(f"[time {name}] B={b} L={l} H={h} D={d} {what} {tag}: median {med:.4f} ms of "
                  f"{[round(t, 4) for t in ts]}; #3's byte bound {bound_ms:.4f} ms, "
                  f"{bound_ms / med:.3f} of it")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
