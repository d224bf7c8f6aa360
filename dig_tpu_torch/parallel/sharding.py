"""Sharded parameters: the FSDP store and the tensor-parallel split.

`shard_model(model, mesh)` applies the placements of `parallel/mesh.py`'s
rules to a model built whole, in place: every sharded parameter keeps only
this rank's piece (`parallel/dist.py::shard_of`), so the optimizer built
afterwards, its state, the EMA of the momentum branch and the gradient
hold pieces too.  A sharded parameter carries its `ShardSpec` as
``param.shard_spec``.  How a module computes with it:

* ``tensor`` placements of the layers that split (`_tp_layers`: the ViT
  `Attention` and `Mlp`, the decoder's `DecoderMHA`,
  `PositionwiseFeedForward` and `TextConditionalMHA`) stay local: the
  layer gets a `TensorParallel` (``layer.tp``) and runs Megatron-style on
  its heads and columns (`parallel/tensor.py`).  A layer whose heads its
  tensor group does not divide (vit_tiny's 3 heads at ``--n_tensor 2``),
  or another layer with a tensor-sharded weight (the PatchNet's
  cross-attention q/k/v, which `dig_tpu` shards with no row rule for its
  projection), gathers the weight before use and takes the gradient of
  its own piece, since every tensor peer computes the same whole product;
* ``fsdp`` placements are gathered over the fsdp group just before the
  module runs.  A `Dense` weight goes through `gathered_linear`: gathered
  in the forward and freed after it, gathered again in the backward (and
  in `--remat`'s recompute, which runs the forward again), its gradient
  reduce-scattered over fsdp.  Any other sharded parameter (position
  embeddings and tokens, the patch projection, convolutions, embeddings,
  the GRU's matrices) is gathered where its module reads it (the module's
  class is given a `__getattr__` that does so), and autograd keeps what
  the reading op saves.

The gradient of a sharded parameter is then summed over the rest of the
data-parallel ranks and divided once by their number (`optim.py`).
`ShardedModel.gathered()` materializes every sharded parameter once, with
no gradient, and runs every layer whole: the eval pass.  Checkpoints hold
the whole tensors (`full_state_dict`, `load_full_state_dict`): the same
file whatever the mesh.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dig_tpu_torch.parallel.dist import all_gather_axis, reduce_scatter_axis, shard_of
from dig_tpu_torch.parallel.mesh import Mesh, Placement, param_shardings
from dig_tpu_torch.parallel.tensor import TensorParallel


class ShardSpec:
    """One sharded parameter: its placement, its group, this rank's index
    in it, the whole shape, and whether its module computes on the piece
    ("local") or on the gathered whole ("gather")."""

    def __init__(self, store: "ShardedModel", name: str, param: nn.Parameter,
                 placement: Placement, mode: str):
        mesh = store.mesh
        self.store, self.name, self.param, self.placement, self.mode = (
            store, name, param, placement, mode)
        self.dim, self.parts = placement.dim, placement.parts
        self.full_shape = tuple(param.shape)
        if placement.mesh_axis == "fsdp":
            self.group, self.index, self.size = mesh.fsdp_group, mesh.fsdp, mesh.n_fsdp
        else:
            self.group, self.index, self.size = mesh.tensor_group, mesh.tensor, mesh.n_tensor
        self.cached: Optional[torch.Tensor] = None

    @property
    def gathers(self) -> bool:
        """Whether a module gathers the parameter at each use now."""
        return self.mode == "gather" and not self.store.is_gathered

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole tensor of the parameter's shape."""
        return shard_of(full, self.dim, self.index, self.size, self.parts)

    def gather_full(self, piece: torch.Tensor) -> torch.Tensor:
        """The whole tensor from the ranks' pieces (no gradient)."""
        return all_gather_axis(piece, self.dim, self.group, self.parts)

    def grad_of_piece(self, g: torch.Tensor) -> torch.Tensor:
        """The gradient of this rank's piece from its gradient of the whole:
        over fsdp the ranks' gradients summed (they saw other rows), over
        tensor this rank's own piece (every peer computed the same whole)."""
        if self.placement.mesh_axis == "fsdp":
            return reduce_scatter_axis(g, self.dim, self.group, self.parts)
        return self.local(g)

    def full(self, piece: torch.Tensor) -> torch.Tensor:
        """The value a module computes with: the gathered whole in the eval
        pass, the piece of a split layer, else the whole gathered now,
        differentiably."""
        if self.store.is_gathered:
            return self.cached
        if self.mode == "local":
            return piece
        return _Gather.apply(piece, self)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, spec):
        ctx.spec = spec
        return spec.gather_full(piece)

    @staticmethod
    def backward(ctx, g):
        return ctx.spec.grad_of_piece(g.contiguous()), None


class _GatheredLinear(torch.autograd.Function):
    """y = x W^T + b with W gathered from its pieces for the forward, freed
    after it, and gathered again for the backward; x and b in `dtype`."""

    @staticmethod
    def forward(ctx, x, piece, bias, spec, dtype):
        ctx.spec, ctx.dtype = spec, dtype
        ctx.save_for_backward(x, piece)
        return F.linear(x, spec.gather_full(piece).to(dtype), bias)

    @staticmethod
    def backward(ctx, gy):
        x, piece = ctx.saved_tensors
        spec = ctx.spec
        w = spec.gather_full(piece).to(ctx.dtype)
        gy2 = gy.reshape(-1, gy.shape[-1])
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = (gy2 @ w).reshape(*gy.shape[:-1], w.shape[1])
        if ctx.needs_input_grad[1]:
            gw = spec.grad_of_piece((gy2.t() @ x.reshape(-1, x.shape[-1])).to(piece.dtype))
        if ctx.needs_input_grad[2]:
            gb = gy2.sum(0)
        return gx, gw, gb, None, None


def gathered_linear(x, piece, bias, spec: ShardSpec, dtype):
    """`F.linear` of `x` and the gathered whole of `piece` (`_GatheredLinear`)."""
    return _GatheredLinear.apply(x, piece, bias, spec, dtype)


def param_value(p: torch.Tensor) -> torch.Tensor:
    """What a module computes with for parameter `p` (`ShardSpec.full`):
    `p` itself when it is not sharded."""
    spec = getattr(p, "shard_spec", None)
    return p if spec is None else spec.full(p)


_GATHERING_CLASSES: Dict[type, type] = {}


def _gathering_class(cls: type) -> type:
    """`cls` with a `__getattr__` that hands out a sharded parameter's
    `param_value`, so the module's own code reads the whole tensor."""
    if cls not in _GATHERING_CLASSES:
        def __getattr__(self, name):
            value = super(sub, self).__getattr__(name)
            return param_value(value) if isinstance(value, nn.Parameter) else value

        sub = type(cls.__name__, (cls,), {"__getattr__": __getattr__,
                                          "__module__": cls.__module__,
                                          "__doc__": cls.__doc__})
        _GATHERING_CLASSES[cls] = sub
    return _GATHERING_CLASSES[cls]


def _tp_layers():
    """{layer class: (column weights, row weights, heads attribute, whether
    the column weight must hold whole heads of q, k and v)} of the layers
    that run split over ``tensor``."""
    from dig_tpu_torch.models.decoder import (
        DecoderMHA,
        PositionwiseFeedForward,
        TextConditionalMHA,
    )
    from dig_tpu_torch.models.layers import Attention, Mlp

    mha = (("linear_q", "linear_k", "linear_v"), ("fc",), "n_head", False)
    return {Attention: (("qkv",), ("proj",), "num_heads", True),
            Mlp: (("fc1",), ("fc2",), None, False), DecoderMHA: mha, TextConditionalMHA: mha,
            PositionwiseFeedForward: (("w_1",), ("w_2",), None, False)}


class ShardedModel:
    """The specs of a model's sharded parameters (`shard_model`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.specs: Dict[str, ShardSpec] = {}
        self.is_gathered = False

    @contextlib.contextmanager
    def gathered(self):
        """Every sharded parameter gathered once, without a gradient, and
        every layer run whole on every rank, for the duration (the eval
        pass: its decode loops may stop at other steps on other ranks)."""
        with torch.no_grad():
            for spec in self.specs.values():
                spec.cached = spec.gather_full(spec.param.detach())
        self.is_gathered = True
        try:
            yield
        finally:
            self.is_gathered = False
            for spec in self.specs.values():
                spec.cached = None


def shard_model(model: nn.Module, mesh: Optional[Mesh],
                min_size: int = 2**16) -> Optional[ShardedModel]:
    """Shard `model` (built whole, on its device) in place by the rules'
    placements for the mesh's axes (`parallel.mesh.param_shardings`; the
    FSDP rule's `min_size`) and return its store, also kept as
    ``model.sharded``; None, with nothing changed, without a mesh that
    shards."""
    if mesh is None or not mesh.sharded:
        return None
    placements = param_shardings(model, mesh.n_fsdp, mesh.n_tensor, min_size)
    store = ShardedModel(mesh)
    params = dict(model.named_parameters())
    local = set()
    tp_layers = _tp_layers()
    for prefix, layer in model.named_modules():
        layout = tp_layers.get(type(layer))
        if layout is None:
            continue
        cols, rows, heads, qkv = layout
        pre = f"{prefix}." if prefix else ""
        want = {f"{pre}{c}.weight": 0 for c in cols}
        want.update({f"{pre}{r}.weight": 1 for r in rows})
        split = all(placements[k].mesh_axis == "tensor" and placements[k].dim == d
                    for k, d in want.items())
        if heads is not None and getattr(layer, heads) % mesh.n_tensor:
            split = False  # the gathered path: every peer runs the whole layer
        if qkv and placements[f"{pre}{cols[0]}.weight"].parts != 3:
            split = False
        if split:
            layer.tp = TensorParallel(mesh.tensor_group, mesh.tensor, mesh.n_tensor, store)
            local.update(want)
    owners = {}
    for prefix, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owners[f"{prefix}.{pname}" if prefix else pname] = mod
    from dig_tpu_torch.models.layers import Dense

    for name, p in params.items():
        placement = placements[name]
        if placement.mesh_axis is None:
            continue
        spec = ShardSpec(store, name, p, placement, "local" if name in local else "gather")
        with torch.no_grad():
            p.data = spec.local(p.data)
        p.shard_spec = spec
        store.specs[name] = spec
        owner = owners[name]
        if (spec.mode == "gather" and not isinstance(owner, Dense)
                and type(owner) not in _GATHERING_CLASSES.values()):
            owner.__class__ = _gathering_class(type(owner))
    model.sharded = store
    return store


def full_numel(p: torch.Tensor) -> int:
    """The elements of parameter `p` whole (its piece's, times the group)."""
    spec = getattr(p, "shard_spec", None)
    return p.numel() if spec is None else int(torch.Size(spec.full_shape).numel())


def store_of(model: nn.Module) -> Optional[ShardedModel]:
    return getattr(model, "sharded", None)


def gathered(model: nn.Module):
    """`ShardedModel.gathered` of a sharded model; a no-op context else."""
    store = store_of(model)
    return store.gathered() if store is not None else contextlib.nullcontext()


@torch.no_grad()
def full_state_dict(model: nn.Module) -> dict:
    """`model.state_dict()` with every sharded parameter whole: a
    collective, every rank calls it (in the state dict's fixed order)."""
    out = model.state_dict()
    store = store_of(model)
    if store is not None:
        for name, spec in store.specs.items():
            out[name] = spec.gather_full(out[name])
    return out


def local_view(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's piece of `full`, a whole tensor of parameter `p`'s
    shape; `full` itself for a parameter that is not sharded."""
    spec = getattr(p, "shard_spec", None)
    return full if spec is None else spec.local(full)


def load_full_state_dict(model: nn.Module, state_dict: dict, strict: bool = True):
    """`model.load_state_dict` of whole tensors, each sharded parameter
    taking its piece."""
    store = store_of(model)
    if store is not None:
        state_dict = dict(state_dict)
        for name, spec in store.specs.items():
            if name in state_dict:
                state_dict[name] = spec.local(state_dict[name].to(spec.param.device))
    return model.load_state_dict(state_dict, strict=strict)
