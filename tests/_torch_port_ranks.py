"""Launch gloo ranks as subprocesses for the port's multi-process tests
(tests/test_torch_port_dist.py, tests/test_torch_port_sharded_steps.py, the
`--n_fsdp` / `--n_tensor` cases of tests/test_torch_port_{pretrain,finetune}_cli.py).

`start` runs a worker script (by default
`tests/_torch_port_sharded_worker.py`) once per rank on a free port, as
``worker <scenario> <dir> <rank> <world> <port>``; `finish` waits for them
under a time limit and loads what each rank saved, relaunching once when
gloo's rendezvous misses its own deadline on a loaded box.  `torchrun`
starts the ranks through `torch.distributed.run` instead, which hands each
its rank and the rendezvous in the launcher's variables."""

import os
import socket
import subprocess
import sys

import torch

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_port_sharded_worker.py")
LAUNCH_TIMEOUT = 240  # seconds a launch's ranks may take
INFRA_FLAKE = "Gloo context initialization failed"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(spec, root, world, worker=WORKER):
    """`world` ranks of `worker` for `spec` (the sharded worker's mesh
    "DxFxT" or "cli"; the data-parallel worker's scenario)."""
    port = _free_port()
    env = dict(os.environ)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return [subprocess.Popen([sys.executable, worker, spec, str(root), str(rank), str(world),
                              str(port)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]


def _wait(procs):
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outputs


def torchrun(spec, root, world, worker=WORKER):
    """`world` ranks of `worker` under torchrun; every rank's saved results."""
    env = dict(os.environ)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    for attempt in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
             str(world), "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
             worker, spec, str(root), "-1", str(world), "-1"],
            env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT)
        out = proc.stdout + proc.stderr
        if attempt == 0 and proc.returncode != 0 and INFRA_FLAKE in out:
            continue
        assert proc.returncode == 0, out[-8000:]
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def finish(spec, root, procs, worker=WORKER):
    """Every rank's saved results, in rank order."""
    world = len(procs)
    for attempt in range(2):
        outputs = _wait(procs)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if attempt == 0 and failed and any(INFRA_FLAKE in o for o in outputs):
            procs = start(spec, root, world, worker)
            continue
        assert not failed, "\n".join(f"rank {r}:\n{outputs[r][-4000:]}" for r in failed)
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
