"""The (data, fsdp, tensor) mesh of the training CLIs and its sharding rules.

Counterpart of `dig_tpu/parallel/mesh.py`.  One process drives one card;
the world's ranks are laid out as ``reshape(n_data, n_fsdp, n_tensor)``,
as the JAX package lays out its devices, so tensor peers are adjacent
ranks.  `create_mesh` gives this rank its coordinates and the process
groups of its axes:

* ``tensor``: the ranks that split a layer's heads and columns between
  them (Megatron; `parallel/tensor.py`).  They compute on the same rows:
  `shard_batch` gathers their loaders' rows in tensor-rank order, as
  `jax.make_array_from_process_local_data` orders the rows of a batch that
  is replicated over ``tensor``;
* ``fsdp``: the ranks that each store a share of a parameter
  (`parallel/sharding.py`); they see different rows;
* ``dp`` = (data, fsdp): the data-parallel ranks.  The batch is sharded
  over them: a rank loads `--batch_size` rows, the global batch is
  `--batch_size` x world (the lr scales with it), and gradients, batch
  statistics and InfoNCE keys are reduced over this group;
* ``data``: the ranks that hold the same share of the FSDP-sharded
  parameters, over which their reduce-scattered gradients are summed.

The rules (`fsdp_param_shardings`, `tp_param_shardings`) are the JAX
package's, applied to the port's parameters through the key mapping of
`utils/convert.py` (`jax_leaf`): the same leaves, along the same axes, with
torch's [out, in] layout flipping a kernel's axes.  A placement names the
mesh axis and the port tensor's dim; ``parts`` 3 splits the dim within
each of three equal parts (the fused qkv's q, k and v, so that a tensor
rank holds whole heads; the GRU's gate matrices), where the JAX package
splits it in one piece.  The rows a rank gathers back are the same.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from dig_tpu_torch.parallel.dist import all_gather_axis
from dig_tpu_torch.utils.convert import jax_leaf

# `dig_tpu/parallel/mesh.py:111-127`: a leaf matches when its JAX key path
# ends with one of these (column: the output dim sharded; row: the input dim)
TP_COLUMN_RULES = (
    ("attn", "qkv_kernel"),
    ("mlp", "Dense_0", "kernel"),
    ("linear_q", "kernel"),
    ("linear_k", "kernel"),
    ("linear_v", "kernel"),
    ("w_1", "kernel"),
    ("q_kernel",),
    ("k_kernel",),
    ("v_kernel",),
)
TP_ROW_RULES = (
    ("attn", "proj", "kernel"),
    ("mlp", "Dense_1", "kernel"),
    ("fc", "kernel"),
    ("w_2", "kernel"),
)


class Placement(NamedTuple):
    """Where a parameter lives: replicated (`mesh_axis` None), or split
    along its dim `dim` over the ranks of `mesh_axis` ("fsdp" or
    "tensor"), within each of `parts` equal parts of that dim."""

    mesh_axis: Optional[str] = None
    dim: Optional[int] = None
    parts: int = 1


REPLICATED = Placement()


@dataclasses.dataclass
class Mesh:
    """This rank's place in the mesh and the groups of its axes.  A group
    is None where it is the whole world (the default group); a group of
    one rank makes its collectives no-ops (`parallel/dist.py`)."""

    n_data: int
    n_fsdp: int
    n_tensor: int
    rank: int = 0
    data: int = 0
    fsdp: int = 0
    tensor: int = 0
    tensor_group: Optional[object] = None
    fsdp_group: Optional[object] = None
    dp_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "fsdp": self.n_fsdp, "tensor": self.n_tensor}

    @property
    def world(self) -> int:
        return self.n_data * self.n_fsdp * self.n_tensor

    @property
    def n_dp(self) -> int:
        """The data-parallel ranks: the batch's shards."""
        return self.n_data * self.n_fsdp

    @property
    def dp_index(self) -> int:
        """This rank's shard of the batch (its tensor peers share it)."""
        return self.data * self.n_fsdp + self.fsdp

    @property
    def sharded(self) -> bool:
        return self.n_fsdp > 1 or self.n_tensor > 1


_MESH: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The mesh `create_mesh` made in this process, None before and after
    `clear_mesh`."""
    return _MESH


def clear_mesh() -> None:
    global _MESH
    _MESH = None


def _new_group(ranks, world):
    """The group of `ranks`; every rank makes every group, in one order."""
    if len(ranks) == world:
        return None
    return dist.new_group(ranks)


def create_mesh(n_fsdp: int = 1, n_tensor: int = 1, n_data: Optional[int] = None) -> Mesh:
    """This rank's (data, fsdp, tensor) coordinates on the world's ranks
    laid out as ``reshape(n_data, n_fsdp, n_tensor)``, and the process
    groups of its axes (`dig_tpu/parallel/mesh.py:30-45`); made the
    process's current mesh.  A world the mesh does not divide raises
    `ValueError`, as the JAX package's assert refuses it.  Every rank of a
    process group calls it, at the same point; alone, the world is 1."""
    global _MESH
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_fsdp < 1 or n_tensor < 1:
        raise ValueError(f"mesh axes must be >= 1 (got --n_fsdp {n_fsdp} --n_tensor {n_tensor})")
    if n_data is None:
        if world % (n_fsdp * n_tensor):
            raise ValueError(f"mesh ?x{n_fsdp}x{n_tensor} does not divide {world} devices")
        n_data = world // (n_fsdp * n_tensor)
    if n_data * n_fsdp * n_tensor != world:
        raise ValueError(f"mesh {n_data}x{n_fsdp}x{n_tensor} != {world} devices")
    grid = np.arange(world).reshape(n_data, n_fsdp, n_tensor)
    d, f, t = (int(i[0]) for i in np.nonzero(grid == rank))
    mesh = Mesh(n_data, n_fsdp, n_tensor, rank, d, f, t)
    if world > 1:
        # one fixed order of new_group calls on every rank
        for name, lists in (
                ("tensor_group", [grid[i, j, :] for i in range(n_data) for j in range(n_fsdp)]),
                ("fsdp_group", [grid[i, :, k] for i in range(n_data) for k in range(n_tensor)]),
                ("dp_group", [grid[:, :, k].reshape(-1) for k in range(n_tensor)]),
                ("data_group", [grid[:, j, k] for j in range(n_fsdp) for k in range(n_tensor)])):
            for ranks in lists:
                group = _new_group([int(r) for r in ranks], world)
                if rank in ranks:
                    setattr(mesh, name, group)
    _MESH = mesh
    return mesh


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

def local_batch(batch_size: int) -> int:
    """The rows one rank loads a step: `--batch_size` (its tensor group's
    step holds `--batch_size` x n_tensor of them, `shard_batch`)."""
    return batch_size


def shard_batch(batch: dict) -> dict:
    """A rank's loaded batch -> the rows its step computes on: the tensor
    group's batches concatenated in tensor-rank order (every tensor peer
    holds the same rows); the batch as it is without tensor peers."""
    mesh = current_mesh()
    if mesh is None or mesh.n_tensor == 1:
        return batch
    return {k: all_gather_axis(torch.as_tensor(v), 0, mesh.tensor_group) for k, v in batch.items()}


def host_local_rows(x):
    """The rows of a step's output that this rank loaded: its share of the
    tensor group's rows (`shard_batch`); all of them without tensor peers."""
    mesh = current_mesh()
    if mesh is None or mesh.n_tensor == 1:
        return x
    n = x.shape[0] // mesh.n_tensor
    return x[mesh.tensor * n:(mesh.tensor + 1) * n]


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _port_dim(key: str, to_port, jax_axis: int) -> int:
    dim = to_port[jax_axis]
    if dim is None:
        raise ValueError(f"{key}: the JAX rule splits an axis that the port's layout "
                         f"flattens into several")
    return dim


def _param_shapes(model) -> dict:
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def fsdp_param_shardings(model, n_fsdp: int, min_size: int = 2**16) -> dict:
    """{parameter name: `Placement`} of `dig_tpu`'s ZeRO-3 rule
    (`dig_tpu/parallel/mesh.py:168-183`): a leaf of >= 2 dims and >=
    `min_size` elements is split over ``fsdp`` along its largest JAX axis
    (the first on a tie), when that axis divides; every other leaf is
    replicated.  `model` holds its full (unsharded) parameters."""
    out = {}
    for key, shape in _param_shapes(model).items():
        out[key] = REPLICATED
        if n_fsdp == 1 or len(shape) < 2 or int(np.prod(shape)) < min_size:
            continue
        _, jshape, to_port, parts = jax_leaf(key, shape)
        axis = int(np.argmax(jshape))
        if jshape[axis] % n_fsdp:
            continue
        dim = _port_dim(key, to_port, axis)
        out[key] = Placement("fsdp", dim, parts if dim == 0 else 1)
    return out


def _endswith(keys: tuple, suffix: tuple) -> bool:
    return len(keys) >= len(suffix) and keys[-len(suffix):] == suffix


def tp_param_shardings(model, n_tensor: int, base: Optional[dict] = None) -> dict:
    """{parameter name: `Placement`} of `dig_tpu`'s Megatron rule
    (`dig_tpu/parallel/mesh.py:138-165`): a >= 2-D leaf whose JAX path ends
    with a column rule is split over ``tensor`` along its JAX output axis,
    one that ends with a row rule along its input axis, each when that axis
    divides; every other leaf keeps its placement in `base` (the
    `fsdp_param_shardings` of the same model), or without `base` is
    replicated.  The fused qkv splits within q, k and v where its width
    divides (whole heads a rank)."""
    out = {}
    for key, shape in _param_shapes(model).items():
        out[key] = base[key] if base is not None else REPLICATED
        if n_tensor == 1 or len(shape) < 2:
            continue
        path, jshape, to_port, parts = jax_leaf(key, shape)
        if any(_endswith(path, c) for c in TP_COLUMN_RULES) and jshape[-1] % n_tensor == 0:
            dim = _port_dim(key, to_port, len(jshape) - 1)
            if _endswith(path, ("attn", "qkv_kernel")) and (jshape[-1] // 3) % n_tensor == 0:
                parts = 3
            out[key] = Placement("tensor", dim, parts if dim == 0 else 1)
        elif any(_endswith(path, r) for r in TP_ROW_RULES) and jshape[0] % n_tensor == 0:
            dim = _port_dim(key, to_port, 0)
            out[key] = Placement("tensor", dim, parts if dim == 0 else 1)
    return out


def param_shardings(model, n_fsdp: int, n_tensor: int, min_size: int = 2**16) -> dict:
    """The composition the JAX CLIs and its mesh-invariance test take: the
    FSDP rule, then the TP rule over it."""
    return tp_param_shardings(model, n_tensor, base=fsdp_param_shardings(model, n_fsdp, min_size))
