"""MurmurHash3_x64_128: building blocks on int64 tensors, and the scalar
hash of one byte string.

Counterpart of ``rkmh_tpu/ops/murmur3.py:27-31,121-131``.  Values are
uint64 bit patterns held in int64: multiplication, addition, XOR and left
shifts wrap exactly as uint64 arithmetic does, but ``>>`` on int64 is
arithmetic, so every right shift is masked down to a logical one.
Constants at or above 2**63 enter as their negative int64 equivalents.
``murmur3_x64_128_np`` is a copy of the JAX package's scalar reference
(``rkmh_tpu/ops/murmur3.py:52``, Python integers), which hashes the
reference tokens of ``search`` on the host.
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


_MASK64 = 0xFFFFFFFFFFFFFFFF


def _rotl64_int(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _fmix64_int(k: int) -> int:
    k ^= k >> 33
    k = (k * (FMIX1 & _MASK64)) & _MASK64
    k ^= k >> 33
    k = (k * (FMIX2 & _MASK64)) & _MASK64
    k ^= k >> 33
    return k


def murmur3_x64_128_np(data: bytes, seed: int = 42) -> tuple[int, int]:
    """(h1, h2) of MurmurHash3_x64_128(data, seed) as unsigned Python ints."""
    c1, c2 = C1 & _MASK64, C2 & _MASK64
    length = len(data)
    nblocks = length // 16
    h1 = h2 = seed & _MASK64
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16: i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8: i * 16 + 16], "little")
        h1 ^= (_rotl64_int((k1 * c1) & _MASK64, 31) * c2) & _MASK64
        h1 = (_rotl64_int(h1, 27) + h2) & _MASK64
        h1 = (h1 * 5 + 0x52DCEFB5) & _MASK64
        h2 ^= (_rotl64_int((k2 * c2) & _MASK64, 33) * c1) & _MASK64
        h2 = (_rotl64_int(h2, 31) + h1) & _MASK64
        h2 = (h2 * 5 + 0x38495AB5) & _MASK64
    tail = data[nblocks * 16:]
    if len(tail) >= 9:
        k2 = int.from_bytes(tail[8:], "little")
        h2 ^= (_rotl64_int((k2 * c2) & _MASK64, 33) * c1) & _MASK64
    if tail:
        k1 = int.from_bytes(tail[:8], "little")
        h1 ^= (_rotl64_int((k1 * c1) & _MASK64, 31) * c2) & _MASK64
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    h1, h2 = _fmix64_int(h1), _fmix64_int(h2)
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    return h1, h2
