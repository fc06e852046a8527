"""MurmurHash3_x64_128 building blocks on int64 tensors.

Counterpart of ``rkmh_tpu/ops/murmur3.py:27-31,121-131``.  Values are
uint64 bit patterns held in int64: multiplication, addition, XOR and left
shifts wrap exactly as uint64 arithmetic does, but ``>>`` on int64 is
arithmetic, so every right shift is masked down to a logical one.
Constants at or above 2**63 enter as their negative int64 equivalents.
"""

from __future__ import annotations

import torch


def as_i64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= 1 << 63 else v


C1 = as_i64(0x87C37B91114253D5)
C2 = as_i64(0x4CF5AD432745937F)
FMIX1 = as_i64(0xFF51AFD7ED558CCD)
FMIX2 = as_i64(0xC4CEB9FE1A85EC53)


def shr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of uint64 bit patterns held in int64, 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | shr64(x, 64 - r)


def fmix64(k: torch.Tensor) -> torch.Tensor:
    k = k ^ shr64(k, 33)
    k = k * FMIX1
    k = k ^ shr64(k, 33)
    k = k * FMIX2
    k = k ^ shr64(k, 33)
    return k
