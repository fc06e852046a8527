"""Lossy hash-table k-mer depth counter (rkmh's HASHTCounter).

Counterpart of ``rkmh_tpu/ops/counter.py`` (``_slots`` :30, ``counter_add``
:37, ``counter_get`` :46, ``HashCounter`` :52).  The table is int32
``[size]`` on the device, indexed by the unsigned 64-bit ``hash % size``
(a mask when size is a power of two), collisions and all, so -M/-I
outputs match rkmh-tpu's.  Every masked-in window counts, hash 0 (an
invalid k-mer) included: it lands in slot 0.

On a CUDA tensor ``counter_add`` is the counter-add kernel (K6) and
``counter_mask`` the fused gather-and-mask kernel (K7), both in
``csrc/counter.cu``; on a CPU tensor they are ``counter_add_plain`` and
``counter_mask_plain``, which the kernels must match exactly.
"""

from __future__ import annotations

import torch
from torch import nn

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.sketch import mask_by_frequency_range

INT32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF


def _check_size(size: int) -> int:
    size = int(size)
    if not 1 <= size <= INT32_MAX:
        raise ValueError(f"counter size must be in [1, 2**31), got {size}")
    return size


def slots(hashes: torch.Tensor, size: int) -> torch.Tensor:
    """The unsigned ``hash % size`` of int64 bit patterns, as int64.

    torch has no unsigned 64-bit remainder, so a hash splits into 32-bit
    halves: ``((hi % m) * (2**32 % m) + lo) % m``, every term below 2**62
    for m < 2**31."""
    m = _check_size(size)
    if m & (m - 1) == 0:
        return hashes & (m - 1)
    hi = (hashes >> 32) & _M32
    lo = hashes & _M32
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def counter_add_plain(table: torch.Tensor, hashes: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """table[h % size] += 1 for every masked-in hash, in place."""
    h = hashes.reshape(-1)
    if mask is not None:
        h = h[mask.reshape(-1)]
    idx = slots(h, table.shape[0])
    return table.index_add_(0, idx, torch.ones_like(idx, dtype=table.dtype))


def counter_get_plain(table: torch.Tensor, hashes: torch.Tensor) -> torch.Tensor:
    """The (collision-lossy) count of each hash."""
    return table[slots(hashes, table.shape[0])]


def counter_mask_plain(table: torch.Tensor, hashes: torch.Tensor, lo: int,
                       hi: int) -> torch.Tensor:
    """Each hash whose count lies in [lo, hi], 0 elsewhere."""
    return mask_by_frequency_range(hashes, counter_get_plain(table, hashes), lo, hi)


def _check(table: torch.Tensor, hashes: torch.Tensor) -> None:
    if table.dtype != torch.int32 or table.dim() != 1 or not table.is_contiguous():
        raise ValueError("a counter table is a contiguous 1-D int32 tensor")
    _check_size(table.shape[0])
    if hashes.dtype != torch.int64 or hashes.device != table.device:
        raise ValueError(f"counter takes int64 hashes on the table's device, got "
                         f"{hashes.dtype} on {hashes.device}")


def _counter_add_cuda(table, hashes, mask):
    _check(table, hashes)
    hashes = hashes.contiguous()
    if mask is not None:
        if mask.shape != hashes.shape or mask.dtype != torch.bool or mask.device != table.device:
            raise ValueError("the counter mask is bool, of the hashes' shape and device")
        mask = mask.contiguous()
    if hashes.numel():
        kernels.COUNTER_ADD(hashes, mask, hashes.numel(), table, table.shape[0])
    return table


def _counter_mask_cuda(table, hashes, lo, hi):
    _check(table, hashes)
    hashes = hashes.contiguous()
    out = torch.empty_like(hashes)
    if hashes.numel():
        kernels.COUNTER_MASK(hashes, hashes.numel(), table, table.shape[0], lo, hi, out)
    return out


def counter_add(table: torch.Tensor, hashes: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """table[h % size] += 1 for every masked-in hash (mask None: all), in
    place; returns the table."""
    if table.device.type == "cuda":
        return _counter_add_cuda(table, hashes, mask)
    if table.device.type != "cpu":
        raise ValueError(f"no counter path for device {table.device}")
    return counter_add_plain(table, hashes, mask)


def counter_mask(table: torch.Tensor, hashes: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Hashes whose count lies in [lo, hi], 0 elsewhere: -M keeps
    (min_occ, INT32_MAX), -I keeps (0, max_samples)."""
    # counts are int32: bounds clamped to its range select the same counts
    lo, hi = max(int(lo), -INT32_MAX - 1), min(int(hi), INT32_MAX)
    if table.device.type == "cuda":
        return _counter_mask_cuda(table, hashes, lo, hi)
    if table.device.type != "cpu":
        raise ValueError(f"no counter path for device {table.device}")
    return counter_mask_plain(table, hashes, lo, hi)


class HashCounter(nn.Module):
    """A ``hash % size`` depth counter whose int32 table is a buffer,
    allocated zeroed on ``device`` (never on the host for a GPU)."""

    def __init__(self, size: int, device: torch.device | str = "cpu"):
        super().__init__()
        self.register_buffer("table", torch.zeros(_check_size(size), dtype=torch.int32,
                                                  device=device))

    def add(self, hashes: torch.Tensor, mask: torch.Tensor | None = None) -> HashCounter:
        counter_add(self.table, hashes, mask)
        return self
