#!/usr/bin/env python3
"""Time the ways two gloo ranks on one card can reduce a tensor.

    python3 tools/time_gloo_collectives.py

Starts itself under torchrun with two ranks, both on card 0 in one gloo
group (NCCL takes one rank a device), and times, on a [65,536, 384] bf16
tensor (one pre-training step's activation between tensor peers: 256
sequences x 256 tokens x 384) and its fp32 copy, the mean of 5 calls after
one: the copy to pageable and to pinned host memory; an all-reduce of a
float32 host copy (the port's first path); gloo's own all-reduce of the
tensor on the card, fp32 and bf16 (the path `parallel/dist.py::all_reduce_copy`
takes); an all-gather of the bf16 bits as int16, which gloo refuses.
Rank 0 prints one line a way, then the card's name and power limit.
"""

import datetime
import os
import socket
import subprocess
import sys
import time


def main():
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    x16 = torch.randn(256 * 256, 384, device="cuda").to(torch.bfloat16)
    x32 = x16.float()

    def timed(name, fn, n=5):
        try:
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            text = f"{(time.perf_counter() - t0) / n * 1e3:.1f} ms"
        except RuntimeError as e:
            text = f"refused: {e}"
        if rank == 0:
            print(f"{name}: {text}", flush=True)

    def to_pinned(x):
        y = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        y.copy_(x)
        return y

    def host_fp32(x):
        y = x.detach().to("cpu", torch.float32, copy=True).contiguous()
        dist.all_reduce(y)
        return y.to(x.device, x.dtype)

    def on_card(x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    def gather_bits(x):
        src = x.view(torch.int16)
        out = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(out, src)
        return out

    timed("copy of the bf16 tensor to pageable host memory", lambda: x16.to("cpu"))
    timed("copy of the bf16 tensor to pinned host memory", lambda: to_pinned(x16))
    timed("all-reduce of a float32 host copy of the bf16 tensor", lambda: host_fp32(x16))
    timed("all-reduce of the fp32 tensor's host copy", lambda: host_fp32(x32))
    timed("gloo all-reduce of the fp32 tensor on the card", lambda: on_card(x32))
    timed("gloo all-reduce of the bf16 tensor on the card", lambda: on_card(x16))
    timed("gloo all-gather of the bf16 bits as int16", lambda: gather_bits(x16))
    dist.destroy_process_group()
    if rank == 0:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


def launch():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
                           "--master_port", str(port), os.path.abspath(__file__)]).returncode


if __name__ == "__main__":
    sys.exit(main() if "RANK" in os.environ else launch())
