"""Integer stream keys for the port's random draws.

``jax.random`` keys become 63-bit integers that seed a
``torch.Generator``; ``fold_in`` derives an independent stream from a
key and an integer, as ``jax.random.fold_in`` does (the bits differ:
torch cannot replay ``jax.random``).
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64's finalizer: a well-spread 64-bit hash of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from ``key`` and ``data``."""
    return mix64((int(key) & MASK64) ^ mix64(int(data) & MASK64)) >> 1


def generator(key: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(int(key))
