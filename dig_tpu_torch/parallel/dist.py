"""Process groups and collectives of data-parallel training.

Counterpart of `dig_tpu/parallel/dist.py` and of the collectives that GSPMD
inserts for the JAX package's mesh.  One process drives one card; N
processes with local batches b compute what one process computes on the
global batch N * b (the reference's DDP over NCCL: `init_distributed_mode`,
utils/utils.py:375-407; `concat_all_gather`,
modeling_pretrain_moco_mim_ori.py:581-593):

* `init_distributed_mode` finds rank and world size (explicit arguments,
  then torchrun's RANK / WORLD_SIZE / LOCAL_RANK, then Open MPI's, then
  SLURM's, else one process with no group) and creates the process group:
  NCCL when the device is a card, gloo only when the caller asks for the
  CPU.  A failed NCCL set-up raises; nothing falls back to another backend.
* `concat_all_gather` (no gradient), `all_reduce_sum` (an autograd
  Function whose backward is an all-reduce-sum too), `all_reduce_floats`,
  `mean_over_ranks` and `broadcast_floats` on the host, `broadcast_module` (rank 0's weights
  at start-up), and `GradientReducer`; each over the world, or over the
  process `group` given (a mesh axis, `parallel/mesh.py`);
* `all_gather_axis`, `reduce_scatter_axis` and `all_reduce_copy`, the
  collectives of sharded parameters and split layers
  (`parallel/{sharding,tensor}.py`): NCCL keeps the tensors on the card,
  gloo copies them through the host itself.

Every collective is a no-op without a process group, so one process runs
exactly the arithmetic it ran before this module existed; at world size 1
with a group the collectives copy, and the results are the same bits.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# (rank, world size, local rank) variables of each launcher, in the order
# they are looked for: torchrun / torch.distributed.launch, Open MPI, SLURM
_LAUNCHERS = (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
              ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"))


def _from_launcher():
    """(rank, world size, local rank) from the first launcher whose rank and
    world size are both set, else None."""
    for rank_var, world_var, local_var in _LAUNCHERS:
        rank, world = os.environ.get(rank_var), os.environ.get(world_var)
        if rank and world:
            return int(rank), int(world), int(os.environ.get(local_var) or 0)
    return None


def is_distributed() -> bool:
    """Whether a process group exists in this process."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_world_size(group=None) -> int:
    """The ranks of `group` (the world by default); 1 alone."""
    return dist.get_world_size(group) if is_distributed() else 1


def _skip(group) -> bool:
    """Whether a collective over `group` has nothing to do: no process
    group, or a group of one rank."""
    return not is_distributed() or dist.get_world_size(group) == 1


def is_main_process() -> bool:
    return get_rank() == 0


def _collective_device() -> torch.device:
    """Where a host value goes for a collective: NCCL reduces only tensors
    on the card."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed_mode(device="cuda", rank: Optional[int] = None,
                          world_size: Optional[int] = None, local_rank: Optional[int] = None,
                          init_method: Optional[str] = None,
                          timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> dict:
    """Create the process group of this process, or find the caller's.

    Rank, world size and local rank come from the arguments, else from the
    first launcher's variables (`_LAUNCHERS`); with neither, the process
    runs alone and no group is created.  `device` "cuda" binds the process
    to card `local_rank` and takes NCCL (raising where NCCL is missing);
    "cpu" takes gloo.  The group's rendezvous is `init_method`, else
    ``env://`` (MASTER_ADDR, MASTER_PORT).  `timeout` bounds every
    collective, so a rank that never arrives fails the others instead of
    hanging them.

    Returns {"rank", "world_size", "local_rank", "device", "backend",
    "created"}: `backend` None without a group; `created` whether this call
    made the group (its caller then owns `destroy`)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"data-parallel training runs on cuda or cpu, not {device}")
    found = _from_launcher()
    if is_distributed():
        local = local_rank if local_rank is not None else (found[2] if found else 0)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
                "local_rank": local, "device": device, "backend": dist.get_backend(),
                "created": False}
    if world_size is None:
        if found is None:
            return {"rank": 0, "world_size": 1, "local_rank": 0, "device": device,
                    "backend": None, "created": False}
        world_size = found[1]
        rank = found[0] if rank is None else rank
        local_rank = found[2] if local_rank is None else local_rank
    rank = 0 if rank is None else rank
    local_rank = 0 if local_rank is None else local_rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if init_method is None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
            raise ValueError("a process group needs its rendezvous: set MASTER_ADDR and "
                             "MASTER_PORT (torchrun does) or pass init_method")
        init_method = "env://"
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; data-parallel training on the card "
                               "needs it")
        torch.cuda.set_device(local_rank)
        device, backend = torch.device("cuda", local_rank), "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return {"rank": rank, "world_size": world_size, "local_rank": local_rank,
            "device": device, "backend": backend, "created": True}


def barrier() -> None:
    """Every rank waits here for the others (no-op alone)."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def destroy() -> None:
    """Tear the process group down, if there is one.  No barrier first: a
    rank that leaves on an error must not wait for ranks that will never
    arrive."""
    if is_distributed():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@torch.no_grad()
def concat_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order, without a
    gradient (the reference's `concat_all_gather`, for the momentum keys)."""
    if _skip(group):
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of each rank's x is the sum
    over ranks of the gradient of y, since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable (its
    backward is an all-reduce-sum as well); `x` itself alone."""
    if _skip(group):
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_copy(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The sum (or with `op` "max" the maximum) over `group` of `x`, as a new
    tensor on x's device.  A tensor on the card goes to the backend as it
    is: NCCL reduces it there, gloo through host memory of its own, four
    times as fast for two ranks on one H100 as a float32 copy reduced on
    the host (`tools/time_gloo_collectives.py`, PERF.md §5)."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=red, group=group)
    return y


@torch.no_grad()
def all_gather_axis(x: torch.Tensor, dim: int, group=None, parts: int = 1) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order; with `parts`
    > 1, `x` along `dim` is `parts` equal pieces, and each piece is
    gathered on its own (the result's piece i is the ranks' pieces i).
    Without a gradient; on `x`'s device.  Floats go to the backend where
    they are; other types (a batch's uint8 images and bool masks), which
    gloo takes only on the host, through the host."""
    if _skip(group):
        return x
    n = dist.get_world_size(group)
    if x.is_floating_point() or dist.get_backend(group) == "nccl":
        src = x.contiguous()
    else:
        src = x.detach().to("cpu").contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    if parts == 1:
        full = torch.cat(out, dim=dim)
    else:
        pieces = [t.chunk(parts, dim=dim) for t in out]
        full = torch.cat([pieces[r][i] for i in range(parts) for r in range(n)], dim=dim)
    return full.to(x.device)


def shard_of(full: torch.Tensor, dim: int, index: int, size: int, parts: int = 1) -> torch.Tensor:
    """Rank `index`'s piece of `full` along `dim` among `size` ranks, the
    inverse of `all_gather_axis` (a copy)."""
    if size == 1:
        return full
    return torch.cat([piece.chunk(size, dim=dim)[index]
                      for piece in full.chunk(parts, dim=dim)], dim=dim).contiguous()


@torch.no_grad()
def reduce_scatter_axis(x: torch.Tensor, dim: int, group=None, parts: int = 1) -> torch.Tensor:
    """The sum over the ranks of `x`, of which this rank keeps its piece
    along `dim` (`shard_of`).  Over gloo, an all-reduce on the host and a
    slice (gloo has no reduce-scatter); over NCCL, a reduce-scatter."""
    if _skip(group):
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        src = torch.stack([shard_of(x, dim, i, n, parts) for i in range(n)])
        out = torch.empty_like(src[0])
        dist.reduce_scatter_tensor(out, src, group=group)
        return out
    return shard_of(all_reduce_copy(x, group), dim, r, n, parts)


def all_reduce_floats(values: Sequence[float], op: str = "sum", group=None) -> List[float]:
    """Host numbers reduced over the ranks of `group` ("sum" or "max"), in
    float64; the same numbers alone."""
    if _skip(group):
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    t = t.to(_collective_device())
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return [float(v) for v in t.cpu()]


def mean_over_ranks(values: dict) -> dict:
    """Numbers (or device scalars) by name, each the mean over the ranks of
    their values, on the host: a step's loss over the global batch, as the
    JAX step logs it, and one value on every rank, so that every rank takes
    the same decision on it (a non-finite loss stops all of them)."""
    sums = all_reduce_floats([float(v) for v in values.values()])
    world = get_world_size()
    return {k: v / world for k, v in zip(values, sums)}


def broadcast_floats(values: Sequence[float], src: int = 0) -> List[float]:
    """Rank `src`'s numbers on every rank, in float64."""
    if not is_distributed():
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64).to(_collective_device())
    dist.broadcast(t, src)
    return [float(v) for v in t.cpu()]


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` (the momentum branch too)
    made rank `src`'s, in place."""
    if not is_distributed():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src)


class GradientReducer:
    """The data-parallel gradient: for a fixed list of parameters, the sum
    of the gradients of `group`'s ranks (the world by default) divided once
    by `divisor`, by default the group's size: the number of data-parallel
    ranks, which under a mesh is not the world (`parallel/mesh.py`: the
    FSDP-sharded parameters sum over ``data`` after their reduce-scatter
    over ``fsdp`` and divide by both).  One flat
    buffer and one all-reduce per (dtype, device) group, the parameters in
    their fixed order, so every rank issues the same collectives.  The
    buffers and each parameter's view into them are made once and kept:
    a call copies the gradients in with one fused copy a group, so its
    host time does not grow with the number of parameters.  Each view
    starts at a multiple of `ALIGN_BYTES` from its buffer's start, as a
    fresh allocation would, so the kernels that read the reduced gradients
    take the same vectorised paths, and sum in the same order, as on a
    fresh gradient: at world size 1 the step's bits are the single
    process's.  A gradient that is None counts as zero on that rank (the
    optimizer steps such a parameter with a zero gradient, as optax does).
    The returned gradients are views that the next call overwrites.  The
    reduction starts after the whole backward; overlapping it with the
    backward is not done."""

    ALIGN_BYTES = 256

    def __init__(self, params: Sequence[torch.Tensor], group=None,
                 divisor: Optional[int] = None):
        self.params = list(params)
        self.group = group
        self.divisor = get_world_size(group) if divisor is None else int(divisor)
        groups = {}
        for i, p in enumerate(self.params):
            groups.setdefault((p.dtype, p.device), []).append(i)
        self.groups = []  # (flat buffer, parameter indices, their views)
        for (dtype, device), idx in groups.items():
            align = max(1, self.ALIGN_BYTES // torch.empty((), dtype=dtype).element_size())
            offsets, total = [], 0
            for i in idx:
                offsets.append(total)
                total += -(-self.params[i].numel() // align) * align
            flat = torch.zeros(total, dtype=dtype, device=device)
            views = [flat[o:o + self.params[i].numel()].view_as(self.params[i])
                     for i, o in zip(idx, offsets)]
            self.groups.append((flat, idx, views))

    def reduce(self, grads: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """`grads` aligned with the parameters -> the reduced gradients, each
        a view into its group's buffer."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for flat, idx, views in self.groups:
            given = [(v, grads[i]) for v, i in zip(views, idx) if grads[i] is not None]
            missing = [v for v, i in zip(views, idx) if grads[i] is None]
            if given:
                torch._foreach_copy_([v for v, _ in given], [g for _, g in given])
            if missing:
                torch._foreach_zero_(missing)
            if not _skip(self.group):
                dist.all_reduce(flat, group=self.group)
            flat.div_(self.divisor)
            for i, v in zip(idx, views):
                out[i] = v
        return out
