"""One gloo rank of tests/test_torch_port_bench.py, on the CPU.

    python tests/_torch_port_bench_worker.py <mode> <dir> <rank> <world> <port>

Joins a process group of `world` gloo ranks at tcp://127.0.0.1:<port>,
runs `bench_torch.main(device="cpu")` in BENCH_MODE <mode> at the micro
width (batch 2 a rank, 2 steps) and writes what it printed to
``<dir>/rank<rank>.pt``.  Imports neither jax nor dig_tpu.
"""

import contextlib
import io
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import bench_torch  # noqa: E402
from dig_tpu_torch.parallel.dist import destroy, init_distributed_mode  # noqa: E402

MODELS = {"pretrain": "pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
          "finetune": "vit_micro_patch4_32x128"}


def main(mode, root, rank, world, port):
    os.environ.update(BENCH_MODE=mode, BENCH_MODEL=MODELS[mode], BENCH_BATCH="2",
                      BENCH_STEPS="2", BENCH_PEAK_TFLOPS="1")
    torch.set_num_threads(1)
    init_distributed_mode("cpu", rank=rank, world_size=world,
                          init_method=f"tcp://127.0.0.1:{port}")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench_torch.main("cpu")
    finally:
        destroy()
    torch.save({"rc": rc, "stdout": out.getvalue()}, os.path.join(root, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:6]))
