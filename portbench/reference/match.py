"""Set arithmetic for the references: runs of equal hashes, lookups of
(row, hash) pairs in a sorted list of (hash, column) entries, and the
unsigned ``hash % size`` slots of rkmh's lossy counter."""

from __future__ import annotations

import torch

INT64_MIN = -(1 << 63)


def unsigned_sort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x sorted as uint64 bit patterns along ``dim``."""
    return torch.sort(x ^ INT64_MIN, dim=dim).values ^ INT64_MIN


def slots(h: torch.Tensor, size: int) -> torch.Tensor:
    """The unsigned ``h % size`` (size < 2**31) of int64 bit patterns."""
    hi, lo = (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF
    return ((hi % size) * ((1 << 32) % size) + lo) % size


def slot_counts(h: torch.Tensor, size: int):
    """(sorted distinct slots, their counts) of every hash in ``h``."""
    return torch.unique(slots(h, size), return_counts=True)


def count_of(h: torch.Tensor, size: int, table) -> torch.Tensor:
    """The counter's count for each hash, from ``slot_counts``' table."""
    keys, cnt = table
    s = slots(h, size)
    if keys.numel() == 0:
        return torch.zeros_like(s)
    at = torch.searchsorted(keys, s).clamp(max=keys.numel() - 1)
    return torch.where(keys[at] == s, cnt[at], torch.zeros_like(s))


def row_runs(rows: torch.Tensor, vals: torch.Tensor):
    """(row, value, multiplicity) of each distinct pair, for pairs sorted by
    row and then value."""
    if rows.numel() == 0:
        return rows, vals, rows
    new = torch.ones_like(rows, dtype=torch.bool)
    new[1:] = (rows[1:] != rows[:-1]) | (vals[1:] != vals[:-1])
    starts = new.nonzero().squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([rows.numel()])])
    return rows[starts], vals[starts], ends - starts


class Entries:
    """(hash, column, weight) entries sorted by hash, for lookups."""

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, weights: torch.Tensor):
        order = torch.argsort(vals)
        self.vals, self.cols, self.weights = vals[order], cols[order], weights[order]

    def hits(self, vals: torch.Tensor):
        """-> (index of the query, entry index) of every entry whose hash
        equals a query's."""
        lo = torch.searchsorted(self.vals, vals)
        hi = torch.searchsorted(self.vals, vals, right=True)
        n = hi - lo
        q = torch.repeat_interleave(torch.arange(vals.numel(), device=vals.device), n)
        first = torch.repeat_interleave(lo - (n.cumsum(0) - n), n)
        return q, first + torch.arange(q.numel(), device=vals.device)
