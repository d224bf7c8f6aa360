"""Index samplers for per-host sharded input pipelines.

Parity targets:

* torch `DistributedSampler` semantics (epoch-seeded global permutation,
  rank-strided shard with padding; wiring at
  run_mae_pretraining_moco.py:350-352) -> `ShardedSampler`,
* `DistributedMultiSrcBatchWiseSampler` (reference:
  dataset/dist_multisrc_batch_sampler.py:14-154): every emitted batch is
  homogeneous w.r.t. source dataset — per-dataset shuffle, truncate to
  batch multiples, rank-strided subsample, then shuffle whole batch
  blocks -> `MultiSourceBatchSampler`.

The port's own copy of `dig_tpu/data/samplers.py`: the same seeds give
the same index sequences.  `rank` / `world` are the data-parallel rank and
world size; 0 / 1 for the one-process runs the port has today.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class ShardedSampler:
    """Epoch-seeded permutation, padded to a multiple of world size,
    rank-strided (matches torch DistributedSampler with shuffle=True)."""

    def __init__(self, dataset_len: int, rank: int = 0, world: int = 1,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.n = dataset_len
        self.rank, self.world = rank, world
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    @property
    def num_samples(self) -> int:
        if self.drop_last:
            return self.n // self.world
        return -(-self.n // self.world)

    def __len__(self):
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            order = g.permutation(self.n)
        else:
            order = np.arange(self.n)
        if self.drop_last:
            total = (self.n // self.world) * self.world
            order = order[:total]
        else:
            total = self.num_samples * self.world
            if total > len(order):  # pad by wrapping (torch semantics)
                order = np.concatenate([order, order[: total - len(order)]])
        return iter(order[self.rank : total : self.world].tolist())


class MultiSourceBatchSampler:
    """Batches are homogeneous per source dataset; block-shuffled."""

    def __init__(self, cumulative_sizes: Sequence[int], batch_size: int,
                 rank: int = 0, world: int = 1, seed: int = 0, shuffle: bool = True):
        self.cum = list(cumulative_sizes)
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        starts = [0] + self.cum[:-1]
        self.ranges = list(zip(starts, self.cum))
        self.global_batch = batch_size * world

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        total = 0
        for lo, hi in self.ranges:
            total += (hi - lo) // self.global_batch
        return total

    def __iter__(self) -> Iterator[List[int]]:
        g = np.random.default_rng(self.seed + self.epoch)
        blocks = []
        for lo, hi in self.ranges:
            idx = np.arange(lo, hi)
            if self.shuffle:
                g.shuffle(idx)
            nb = len(idx) // self.global_batch
            idx = idx[: nb * self.global_batch].reshape(nb, self.global_batch)
            # rank-strided subsample inside each global batch
            local = idx[:, self.rank :: self.world][:, : self.batch_size]
            blocks.extend(local.tolist())
        if self.shuffle:
            order = g.permutation(len(blocks))
            blocks = [blocks[i] for i in order]
        return iter(blocks)
