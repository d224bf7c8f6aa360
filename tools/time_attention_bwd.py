#!/usr/bin/env python3
"""Time the port's two attention backward kernels on the card, pass by pass.

    python3 tools/time_attention_bwd.py [B]

Builds `attention_lse_fwd`, `attention_lse_bwd` and `attention_bwd` from
`dig_tpu_torch/ops/csrc/`, prints the ptxas lines (registers, spills) of
their bf16 D=64 instantiations, checks on the pre-training shapes (B
sequences, default 256, L=256, H=6, D=64, bf16) that the recompute backward
equals the stored-statistics one bit for bit, and times both: whole calls
with CUDA events (two rounds of 30), and the dq and dk/dv passes apart with
torch.profiler.  To compare a tuning constant of `attention_bwd.cuh` (ring
stages, launch bounds), run it from a copy of the package with that
constant edited, both in one call on one card.  Needs a CUDA device.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dig_tpu_torch.ops import _build, attention as attn  # noqa: E402

L, H, D = 256, 6, 64


def time_ms(fn, iters=30):
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


def main():
    if not torch.cuda.is_available():
        print("time_attention_bwd: no CUDA device visible", file=sys.stderr)
        return 1
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sources = ["attention_lse_fwd", "attention_lse_bwd", "attention_bwd"]
    _build.build_all(sources)
    for source in sources[1:]:
        name = ""
        for line in _build.build_log(source).splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "mma_kernelILi64" in name and ("Used" in line or "spill" in line):
                print(f"[ptxas {source}] {name[name.find('attn'):][:34]} {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    c = H * D
    qkv = torch.randn(b, L, 3 * c, generator=gen, device="cuda").bfloat16()
    q, k, v = attn.split_heads(qkv, H)
    do = torch.randn(b, L, H, D, generator=gen, device="cuda").bfloat16()
    scale = D ** -0.5
    _, m, s = attn.attention_lse_fwd(q, k, v, scale)

    def lse():
        return attn.attention_lse_bwd(q, k, v, do, m, s, scale)

    def rec():
        return attn.attention_bwd(q, k, v, do, scale)

    print("attention_bwd bitwise equal to attention_lse_bwd:",
          all(torch.equal(x, y) for x, y in zip(rec(), lse())))
    for _ in range(2):
        print(f"B={b} L={L} H={H} D={D} bf16: attention_lse_bwd {time_ms(lse):.4f} ms, "
              f"attention_bwd {time_ms(rec):.4f} ms")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            lse()
            rec()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "attn_bwd" in e.key:
            print(f"[pass] {e.key[e.key.find('attn_bwd'):][:40]}: "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms x {e.count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
