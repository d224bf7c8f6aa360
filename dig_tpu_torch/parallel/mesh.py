"""What the training CLIs take of `dig_tpu/parallel/mesh.py`.

The JAX package lays its devices out as a (data, fsdp, tensor) mesh and
shards each batch over (data, fsdp).  The port runs one process per card
and only the data axis: each rank's loader yields its own rows
(`ShardedSampler`), so a rank's batch is `--batch_size` and the global
batch `--batch_size` x world size, as the JAX CLIs count it with one device
per host (`dig_tpu/cli/run_pretrain.py:83-84`).  Parameter sharding
(`--n_fsdp`, `--n_tensor`) is not ported yet.
"""

from __future__ import annotations


def check_mesh(n_fsdp: int, n_tensor: int) -> None:
    """Refuse the mesh axes the port does not run."""
    if n_fsdp > 1 or n_tensor > 1:
        raise NotImplementedError(
            f"--n_fsdp {n_fsdp} / --n_tensor {n_tensor}: sharded parameters are not ported "
            f"yet (data parallel only; see ROADMAP.md)")


def local_batch(batch_size: int) -> int:
    """The rows of one rank's step: `--batch_size`, one card a process."""
    return batch_size


def host_local_rows(x):
    """The rows of a step's output that this rank contributed: all of them,
    since a rank's step holds only its own rows."""
    return x
