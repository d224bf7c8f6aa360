#!/usr/bin/env python3
"""Check and time the port's bf16 attention backward kernels on the card.

    python3 tools/time_attention_bwd.py [--rounds N] [--check-only | --time-only] [root ...]

For each root (a directory that holds a `dig_tpu_torch` package; default:
this repository), builds the attention sources from that root's
`dig_tpu_torch/ops/csrc/`, prints the ptxas lines of the bf16 backward
bodies (registers, spills, and any C751x note: wgmma serialised), and
checks #4 (`attention_lse_bwd`) against its plain version at
chip_smoke.py's `BWD_RTOL`, #2 (`attention_bwd`) against #4 bit for bit and
each against a second call bit for bit, on the path's shapes and at ragged
edges.  A root whose `csrc/attention_probe.cu` has the operand-forms probe
also reports whether each form the backward takes gives the forward's
logits bit for bit.  Then times #4, #2 and SDPA's backward (a yardstick)
with CUDA events at the path's shapes: rounds of 30 launches, the roots
taking turns inside each round, so that two bodies (this tree and a
`git archive` of an earlier commit, or a copy with a constant edited) are
compared on one card in one call; and each root's two passes apart with
torch.profiler.  `--time-only` skips the checks, for a copy whose edit
(work left out, to see what it costs) makes its results wrong.  Needs a
CUDA device.
"""

import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ["attention_lse_fwd", "attention_lse_bwd", "attention_bwd"]
# (name, B, L, H, D): the pre-training step, the sequence-class encoder
# (L = 281: 5 key tiles, a ragged last one) and the pre-training step on
# one tensor rank's heads
TIMED = [("pretrain", 256, 256, 6, 64), ("seq-cls", 256, 281, 12, 64),
         ("tensor split", 256, 256, 3, 64)]
# (B, Lq, Lk, H, D) checked only: ragged query blocks and key tiles, the
# other head_dims, the longest Lk the wrapper takes at each head_dim, a
# key count below one tile, fewer keys than queries
EDGES = [(3, 200, 130, 2, 32), (2, 128, 320, 4, 128), (2, 77, 130, 3, 64), (1, 137, 137, 2, 64),
         (2, 256, 387, 2, 64), (1, 150, 419, 2, 32), (1, 128, 322, 2, 128), (3, 50, 40, 2, 64),
         (2, 300, 192, 3, 64), (2, 1, 129, 1, 64)]
ITERS = 30
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BWD_RTOL = 2**-6  # chip_smoke.py's, bf16: relative to each gradient's max |value|


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
    projections, do, and the gradient views of one packed [B, L, 3 H D]
    gradient (zero-filled, so a row written nowhere shows)."""
    c = h * d
    q = torch.randn(b, lq, 3 * c, generator=gen, device="cuda").bfloat16()[..., :c]
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").bfloat16()
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    do = torch.randn(b, lq, h, d, generator=gen, device="cuda").bfloat16()
    grad = torch.zeros(b, max(lq, lk), 3 * c, device="cuda", dtype=torch.bfloat16)
    out = (grad[:, :lq, :c].view(b, lq, h, d), grad[:, :lk, c:2 * c].view(b, lk, h, d),
           grad[:, :lk, 2 * c:].view(b, lk, h, d))
    return q.view(b, lq, h, d), k, v, do, out


def rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(float(ref.float().abs().max()),
                                                                1e-30)


def check(tag, attn, shape, gen):
    """#4 against its plain version, #2 == #4, repeat calls equal; True if
    all hold."""
    b, lq, lk, h, d = shape
    q, k, v, do, out = inputs(b, lq, lk, h, d, gen)
    scale = d**-0.5
    _, m, s = attn.attention_lse_fwd(q, k, v, scale)
    attn.attention_lse_bwd(q, k, v, do, m, s, scale, out=out)
    again = attn.attention_lse_bwd(q, k, v, do, m, s, scale)
    rec = attn.attention_bwd(q, k, v, do, scale)
    rec2 = attn.attention_bwd(q, k, v, do, scale)
    torch.cuda.synchronize()
    ref = attn.attention_lse_bwd_ref(q, k, v, do, m, s, scale)
    rel = [rel_err(g, r) for g, r in zip(out, ref)]
    finite = all(bool(torch.isfinite(g.float()).all()) for g in out)
    repeat = all(bool(torch.equal(x, y)) for x, y in zip(out, again))
    same = all(bool(torch.equal(x, y)) for x, y in zip(out, rec))
    repeat2 = all(bool(torch.equal(x, y)) for x, y in zip(rec, rec2))
    ok = finite and max(rel) <= BWD_RTOL and repeat and same and repeat2
    print(f"[check {tag}] B={b} Lq={lq} Lk={lk} H={h} D={d}: #4 dq / dk / dv "
          f"{rel[0]:.2e} / {rel[1]:.2e} / {rel[2]:.2e} of max |ref| (<= {BWD_RTOL:.2e}), finite "
          f"{finite}; repeat bits {repeat}; #2 equal to #4: {same}, repeat bits {repeat2}; "
          f"{'ok' if ok else 'FAILED'}")
    return ok


def probe(tag, build, gen):
    """The backward's operand forms against the forward's logits; None if
    the root has no forms probe."""
    if not os.path.exists(os.path.join(os.path.dirname(build.__file__), "csrc",
                                       "attention_probe.cu")):
        return None
    lib = build.load("attention_probe")
    if not hasattr(lib, "dig_attn_logits_forms"):
        return None
    fn = lib.dig_attn_logits_forms
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 4096
    q, k = (torch.randn(n, 64, 64, generator=gen, device="cuda").bfloat16() for _ in range(2))
    outs = [torch.empty(n, 64, 64, device="cuda") for _ in range(4)]
    qscale = torch.tensor(64**-0.5 * 1.4426950408889634, dtype=torch.bfloat16).item()
    build.check(lib, fn(q.data_ptr(), k.data_ptr(), *(o.data_ptr() for o in outs), n, qscale,
                        build.stream_ptr(q)), "attention probe")
    torch.cuda.synchronize()
    fwd = outs[0].view(torch.int32)
    differ = {}
    for name, o in zip(("mma.sync", "rows", "cols"), outs[1:]):
        bits = o.view(torch.int32)
        differ[name] = int((bits != fwd).sum())
        print(f"[probe {tag}] {name} vs the forward's wgmma logits of {fwd.numel()} (q, k) pairs "
              f"at D=64: {differ[name]} differ, at most {int((bits - fwd).abs().max())} ulp apart")
    return differ


def ptxas(tag, build):
    for source in SOURCES[1:]:
        name = ""
        for line in build.build_log(source).splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "attn_bwd_" in name and "Li64E" in name and ("Used" in line or "spill" in line):
                print(f"[ptxas {tag} {source}] {name[name.find('attn'):][:48]} {line.strip()}")
        for line in build.build_log(source).splitlines():
            m = re.search(r"\((C75\d\d)\).*function '(\S+)'", line)
            if m:  # C7510-C7518: wgmma serialised; C7519: a fence injected
                name = m[2][m[2].find("attn"):]
                print(f"[ptxas {tag} {source}] {m[1]} in {name[:40]}: "
                      f"{line.split(')', 1)[1].split(' in the function')[0].strip()[:120]}")


def passes(tag, attn, q, k, v, do, m, s, scale):
    """Each kernel's ms a launch, by name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            attn.attention_lse_bwd(q, k, v, do, m, s, scale)
            attn.attention_bwd(q, k, v, do, scale)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "attn_bwd" in e.key:
            print(f"[pass {tag}] {e.key[e.key.find('attn_bwd'):][:56]}: "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms x {e.count}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("roots", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_attention_bwd: no CUDA device visible", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in args.roots] or [HERE]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    mods, ok = {}, True
    for root in roots:
        tag = os.path.relpath(root, HERE)
        attn, build = load_attention(root)
        try:
            build.build_all(SOURCES + ["attention_probe"])
        except RuntimeError as e:  # a root that does not build is reported and left out
            print(f"[build {tag}] FAILED:\n{str(e)[-8000:]}")
            ok = False
            continue
        ptxas(tag, build)
        if args.time_only:
            mods[tag] = attn
            continue
        try:
            differ = probe(tag, build, gen)
            if differ is not None:
                ok &= differ["rows"] == 0 and differ["cols"] == 0
            for name, b, l, h, d in TIMED:
                ok &= check(f"{tag} {name}", attn, (b, l, l, h, d), gen)
            for shape in EDGES:
                ok &= check(f"{tag} edge", attn, shape, gen)
        except RuntimeError as e:  # a launch that fails: reported, the root left out
            print(f"[check {tag}] FAILED: {e}")
            ok = False
            continue
        mods[tag] = attn
    if args.check_only:
        return 0 if ok else 1
    for name, b, l, h, d in TIMED:
        q, k, v, do, _ = inputs(b, l, l, h, d, gen)
        scale = d**-0.5
        _, m, s = mods[next(iter(mods))].attention_lse_fwd(q, k, v, scale)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        # q, k, v, do read, dq, dk, dv written, m and s read
        nbytes = 7 * b * l * h * d * 2 + 2 * b * l * h * 4
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        times = {}
        for r in range(args.rounds):
            order = list(mods) if r % 2 == 0 else list(mods)[::-1]
            for tag in order:
                attn = mods[tag]
                times.setdefault((tag, "#4"), []).append(
                    time_ms(lambda: attn.attention_lse_bwd(q, k, v, do, m, s, scale)))
                times.setdefault((tag, "#2"), []).append(
                    time_ms(lambda: attn.attention_bwd(q, k, v, do, scale)))
            times.setdefault(("", "sdpa backward"), []).append(
                time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), dot, retain_graph=True)))
        for (tag, what), ts in times.items():
            med = sorted(ts)[len(ts) // 2]
            print(f"[time {name}] B={b} L={l} H={h} D={d} {what} {tag}: median {med:.4f} ms of "
                  f"{[round(t, 4) for t in ts]}; the byte bound {bound_ms:.4f} ms, "
                  f"{bound_ms / med:.3f} of it")
        for tag, attn in mods.items():
            passes(f"{tag} {name}", attn, q, k, v, do, m, s, scale)
        del q, k, v, do, m, s, qt, kt, vt, o_lib, dot
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
