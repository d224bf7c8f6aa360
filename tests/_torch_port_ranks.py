"""Launch gloo ranks as subprocesses for the port's multi-process tests
(tests/test_torch_port_dist.py, tests/test_torch_port_sharded_steps.py,
tests/test_torch_port_bench.py, the `--n_fsdp` / `--n_tensor` cases of
tests/test_torch_port_{pretrain,finetune}_cli.py).

`start` runs a worker script (by default
`tests/_torch_port_sharded_worker.py`) once per rank, as
``worker <spec> <dir> <rank> <world> <init_method>``, the rendezvous a
`file://` store of its own under `dir`: no port is picked for the ranks, so
no other launch can take it first.  `finish` waits for them under a time
limit and loads what each rank saved, relaunching once when gloo's
rendezvous misses its own deadline on a loaded box.  `torchrun` starts the
ranks through `torch.distributed.run --standalone`, whose rendezvous store
binds a free port itself and hands it to the ranks.  Every rank runs with
`OMP_NUM_THREADS=1` (tests/_torch_port_threads.py says why)."""

import os
import signal
import subprocess
import sys
import tempfile

import torch

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_port_sharded_worker.py")
LAUNCH_TIMEOUT = 240  # seconds a launch's ranks may take
INFRA_FLAKE = "Gloo context initialization failed"


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return env


def start(spec, root, world, worker=WORKER):
    """`world` ranks of `worker` for `spec` (the sharded worker's mesh
    "DxFxT" or "cli"; the data-parallel worker's scenario)."""
    store = os.path.join(tempfile.mkdtemp(prefix="rendezvous-", dir=os.path.abspath(root)), "store")
    return [_popen([worker, spec, str(root), str(rank), str(world), f"file://{store}"])
            for rank in range(world)]


def _popen(args):
    """A child in a session of its own, so that `_wait` can stop it with
    every process it started (a rank's loader workers, torchrun's ranks)."""
    return subprocess.Popen([sys.executable, *args], env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _wait(procs):
    """Each child's output; all of them, and what they started, killed if
    any outlives LAUNCH_TIMEOUT."""
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0])
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)  # the session's leftovers too
            except ProcessLookupError:
                pass
            if p.poll() is None:
                p.communicate(timeout=30)
    return outputs


def torchrun(spec, root, world, worker=WORKER):
    """`world` ranks of `worker` under torchrun; every rank's saved results."""
    for attempt in range(2):
        proc = _popen(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                       str(world), worker, spec, str(root), "-1", str(world), "env://"])
        (out,) = _wait([proc])
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
