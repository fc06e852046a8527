"""Lossy hash-table k-mer depth counter (rkmh's HASHTCounter).

Counterpart of ``rkmh_tpu/ops/counter.py`` (``_slots`` :30, ``counter_add``
:37, ``counter_get`` :46, ``HashCounter`` :52).  The table is int32
``[size]`` on the device, indexed by the unsigned 64-bit ``hash % size``
(a mask when size is a power of two), collisions and all, so -M/-I
outputs match rkmh-tpu's.  Every masked-in window counts, hash 0 (an
invalid k-mer) included: it lands in slot 0.

On a CUDA tensor ``counter_add`` and ``counter_add_windows`` are the
counter-add kernel (K6) and ``counter_mask`` the fused gather-and-mask
kernel (K7), both in ``csrc/counter.cu``; on a CPU tensor they are
``counter_add_plain`` and ``counter_mask_plain``, which the kernels must
match exactly.  K6 sends an input of ``BINNED_MIN_N`` elements or more
through bins of the table (``bin_plan``; the scratch comes from PyTorch's
allocator here), where equal slots merge before they reach the table, and
a smaller one as one atomic per element.  The bins pay only where a batch
repeats its k-mers, so a ``HashCounter`` reads from its first binned call
how many elements went into each add to the table and sends a pass whose
k-mers are mostly distinct (``MERGE_MIN_RATIO``) as one atomic per element
from then on.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.hashing import window_mask
from rkmh_tpu_torch.ops.sketch import mask_by_frequency_range

INT32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
MAX_BINS = 512        # bins of the binned K6 (csrc/counter.cu)
MAX_KS = 8            # k values K6 derives the window mask for
BINNED_MIN_N = 1 << 17  # elements from which K6 goes through the bins
# elements per add to the table from which the bins beat one atomic per
# element: their scatter and inserts cost about 0.4 of the direct kernel
MERGE_MIN_RATIO = 2.0


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


def remainder_magic(size: int) -> tuple[int, int]:
    """(magic, l) for the kernels' ``h % size`` by a multiply-high
    (Granlund and Montgomery, N = 64): l = ceil(log2(size)) and magic =
    floor(2**64 * (2**l - size) / size) + 1, which fits 64 bits."""
    size = _check_size(size)
    l = (size - 1).bit_length()
    return ((1 << 64) * ((1 << l) - size)) // size + 1, l


def magic_remainder(h: int, size: int, magic: int, l: int) -> int:
    """``slot_of`` of csrc/counter.cu in Python integers, h in [0, 2**64)."""
    if size & (size - 1) == 0:
        return h & (size - 1)
    t = (magic * h) >> 64
    q = ((t + (((h - t) & _M64) >> min(l, 1))) & _M64) >> max(l - 1, 0)
    return (h - q * size) & _M64


def bin_plan(size: int, n: int) -> tuple[int, int, int]:
    """(shift, bins, cap) of the binned K6 for n elements into a table of
    ``size`` slots: bin = slot >> shift, at most MAX_BINS bins (a table
    smaller than that has one bin per slot), each with a list of cap slots:
    twice the mean and some, so that only a skewed input overflows."""
    shift = max(0, (size - 1).bit_length() - (MAX_BINS.bit_length() - 1))
    bins = ((size - 1) >> shift) + 1
    return shift, bins, 2 * -(-n // bins) + 1024


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


def _counter_add_cuda(table, hashes, mask, windows=None, binned: bool | None = None,
                      stats: torch.Tensor | None = None):
    """K6.  ``windows`` = (lengths [B], L, ks) counts the windows of the
    unpadded reads in place of a mask tensor; ``binned`` None lets the
    input's size choose the route.  Returns whether the call went through
    the bins; it then added to ``stats`` (int32 [2] on the device) the adds
    it sent to the table and the elements it merged into them."""
    _check(table, hashes)
    hashes = hashes.contiguous()
    n, size = hashes.numel(), table.shape[0]
    lens, L, ks = None, 0, ()
    if windows is not None:
        lens, L, ks = windows
        ks = [int(k) for k in ks]
        widths = sum(max(L - k + 1, 0) for k in ks)
        if hashes.dim() != 2 or hashes.shape != (lens.shape[0], widths):
            raise ValueError(f"hashes {tuple(hashes.shape)} are not the windows of "
                             f"{lens.shape[0]} reads padded to {L} at k = {ks}")
        if lens.device != table.device:
            raise ValueError("the read lengths lie on another device than the table")
        if len(ks) > MAX_KS or n >= 1 << 32:
            mask, lens = window_mask(lens, L, ks), None
        else:
            lens = lens.to(torch.int32).contiguous()
    if mask is not None:
        if mask.shape != hashes.shape or mask.dtype != torch.bool or mask.device != table.device:
            raise ValueError("the counter mask is bool, of the hashes' shape and device")
        mask = mask.contiguous()
    if not n:
        return False
    magic, l = remainder_magic(size)
    ks_arr = (ctypes.c_int * max(len(ks), 1))(*ks)
    cursor = bins = None
    shift = nbins = cap = 0
    if binned is None:
        binned = n >= BINNED_MIN_N
    if binned:
        shift, nbins, cap = bin_plan(size, n)
        cursor = torch.empty(nbins, dtype=torch.int32, device=table.device)
        bins = torch.empty(nbins * cap, dtype=torch.int32, device=table.device)
    kernels.COUNTER_ADD(hashes, mask, lens, L, ctypes.cast(ks_arr, ctypes.c_void_p), len(ks),
                        n, table, size, magic, l, cursor, bins, shift, nbins, cap,
                        stats if binned else None)
    return binned


def _counter_mask_cuda(table, hashes, lo, hi):
    _check(table, hashes)
    hashes = hashes.contiguous()
    out = torch.empty_like(hashes)
    if hashes.numel():
        kernels.COUNTER_MASK(hashes, hashes.numel(), table, table.shape[0],
                             *remainder_magic(table.shape[0]), lo, hi, out)
    return out


def counter_add(table: torch.Tensor, hashes: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """table[h % size] += 1 for every masked-in hash (mask None: all), in
    place; returns the table."""
    if table.device.type == "cuda":
        _counter_add_cuda(table, hashes, mask)
        return table
    if table.device.type != "cpu":
        raise ValueError(f"no counter path for device {table.device}")
    return counter_add_plain(table, hashes, mask)


def counter_add_windows(table: torch.Tensor, hashes: torch.Tensor, lengths: torch.Tensor,
                        L: int, ks) -> torch.Tensor:
    """``counter_add`` of the [B, W] window hashes of reads padded to L
    with ``window_mask(lengths, L, ks)``, which the kernel derives per
    element instead of reading a [B, W] mask; in place, returns the table."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    if table.device.type == "cuda":
        _counter_add_cuda(table, hashes, None, (lengths, L, ks))
        return table
    if table.device.type != "cpu":
        raise ValueError(f"no counter path for device {table.device}")
    return counter_add_plain(table, hashes, window_mask(lengths, L, ks))


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


def merge_pays(elements: int, adds: int) -> bool:
    """Whether K6's bins beat one atomic per element on input like the call
    that merged ``elements`` into ``adds`` adds to the table."""
    return elements >= MERGE_MIN_RATIO * adds


class HashCounter(nn.Module):
    """A ``hash % size`` depth counter whose int32 table is a buffer,
    allocated zeroed on ``device`` (never on the host for a GPU)."""

    def __init__(self, size: int, device: torch.device | str = "cpu"):
        super().__init__()
        self.register_buffer("table", torch.zeros(_check_size(size), dtype=torch.int32,
                                                  device=device))
        self.binned: bool | None = None  # K6's route; None until a binned call was read

    def add(self, hashes: torch.Tensor, mask: torch.Tensor | None = None) -> HashCounter:
        counter_add(self.table, hashes, mask)
        return self

    def add_windows(self, hashes: torch.Tensor, lengths: torch.Tensor, L: int,
                    ks) -> HashCounter:
        """``counter_add_windows`` into this table.  On a GPU the first
        call that goes through the bins is read back (one synchronisation a
        pass) and sets the route of the later ones."""
        if self.table.device.type != "cuda":
            counter_add_windows(self.table, hashes, lengths, L, ks)
            return self
        windows = (lengths, L, [ks] if isinstance(ks, int) else list(ks))
        if self.binned is None:
            stats = torch.zeros(2, dtype=torch.int32, device=self.table.device)
            if _counter_add_cuda(self.table, hashes, None, windows, stats=stats):
                adds, elements = stats.tolist()
                self.binned = merge_pays(elements, adds)
        else:  # a small input is one atomic per element on either route
            _counter_add_cuda(self.table, hashes, None, windows,
                              binned=None if self.binned else False)
        return self
