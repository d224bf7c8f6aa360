"""Per-step random streams that are a pure function of (seed, stream, step).

Counterpart of `dig_tpu/utils/rng.py`.  The JAX package hands each jitted
step a threefry key built on the host from (seed, stream, global step);
here the same two 32-bit words seed a `torch.Generator` on the step's
device (`step_seed`).  Nothing is carried from one step to the next, so a resumed run
draws, at global step N, exactly what an uninterrupted run drew there.

Streams as the pre-training CLI uses them: 0 = the train step (drop-path),
1 = the on-device view generator (augmentation and masks).

Data-parallel ranks draw from streams of their own: the rank enters the
key's high word (`_RANK`), so ranks drop out, drop paths, mask and augment
differently, and rank 0's key is the single process's, word for word.
Under a mesh (`parallel/mesh.py`) the CLIs key the step's stream (0) by the
data-parallel index, so tensor peers, which compute on the same rows, draw
the same dropout and drop-path masks (a split layer draws the whole mask
and keeps its heads' or columns' slice, `models/layers.py::dropout`); the
view generators' stream (1) stays keyed by the rank, on its own rows.

torch's Philox and JAX's threefry are different generators: the two
packages agree on the *key*, not on the numbers drawn from it.
"""

from __future__ import annotations

import numpy as np
import torch

# Knuth multiplicative hash / golden-ratio constants: cheap host-side
# mixing so (seed, stream) pairs land far apart in key space
_MULT = np.uint32(2654435761)
_GOLD = np.uint32(0x9E3779B9)
_RANK = np.uint32(0x85EBCA6B)  # murmur3's finaliser constant: odd, far from the two above


def host_step_key(seed: int, stream: int, step: int, rank: int = 0) -> np.ndarray:
    """The two uint32 words for (seed, stream, step) on data-parallel rank
    `rank`, built on the host: [hash of (seed, stream, rank), step].  At
    rank 0, word for word the JAX package's key."""
    with np.errstate(over="ignore"):  # the products wrap modulo 2^32 by design
        hi = (np.uint32(seed & 0xFFFFFFFF) * _MULT) ^ (np.uint32(stream) * _GOLD) \
            ^ (np.uint32(rank) * _RANK)
    return np.array([hi, np.uint32(step & 0xFFFFFFFF)], dtype=np.uint32)


def step_seed(seed: int, stream: int, step: int, rank: int = 0) -> int:
    """The 64-bit generator seed for (seed, stream, step, rank): with
    [hi, lo] = `host_step_key(...)`, (hi << 32) | (lo ^ hi).  Distinct keys give
    distinct seeds.  The low word carries `hi` too because torch's CPU
    generator (mt19937) keeps only the low 32 bits of its seed: with the
    bare step there, every seed and stream would draw the same numbers at
    the same step on the CPU.  The card's Philox takes all 64 bits."""
    hi, lo = (int(w) for w in host_step_key(seed, stream, step, rank))
    return (hi << 32) | (lo ^ hi)


def step_generator(seed: int, stream: int, step: int, device="cpu",
                   rank: int = 0) -> torch.Generator:
    """A `torch.Generator` on `device` seeded with
    `step_seed(seed, stream, step, rank)`."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, stream, step, rank))
