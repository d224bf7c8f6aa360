"""Megatron's pair of collectives over the ``tensor`` group.

A column-parallel layer (rank r holds rows r of the output features of its
weight) reads the whole input and writes its share of the features; a
row-parallel layer reads that share and writes a partial sum of the whole
output (Shoeybi et al., "Megatron-LM", 2019, figure 3):

* `copy_to_region` (f): identity forward; the backward sums the input's
  gradient over the tensor peers, since each computed the gradient of its
  share of the features only;
* `reduce_from_region` (g): the forward sums the partial outputs over the
  peers; identity backward, since every peer holds the whole gradient.

`TensorParallel` is what a layer of `models/` holds when it runs split
(`parallel/sharding.py` sets it): the group, this rank's index in it and
its size.  It is inactive while the store's parameters are gathered (the
eval pass runs the whole layer on every rank).
"""

from __future__ import annotations

import torch

from dig_tpu_torch.parallel.dist import all_reduce_copy


class TensorParallel:
    """The tensor group a split layer runs over; `active` is False while the
    sharded store has gathered its parameters (`ShardedModel.gathered`)."""

    def __init__(self, group, rank: int, size: int, store):
        self.group, self.rank, self.size, self.store = group, rank, size, store

    @property
    def active(self) -> bool:
        return not self.store.is_gathered

    def piece(self, n: int) -> slice:
        """This rank's piece of `n` features split evenly."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_copy(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_copy(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_region(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """f: `x` as it is; its gradient summed over the tensor peers."""
    return _CopyToRegion.apply(x, tp.group)


def reduce_from_region(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """g: the sum of the peers' `x`; the gradient passed as it is."""
    return _ReduceFromRegion.apply(x, tp.group)
