"""Occurrence ranks: each sketch element's index within its run of equal
values, which the panel probe pairs with the value.

Counterpart of ``rkmh_tpu/ops/intersect.py::occ_ranks`` (:35) for sorted
rows, and of the sort-free prefix-equality count of
``rkmh_tpu/classify/engine.py:306-311`` for unsorted rows.  Both give the
same multiset of (value, rank) pairs for a row, so the probe counts agree.
Also ``sort_hashes_padded`` (``rkmh_tpu/ops/intersect.py:122``).
"""

from __future__ import annotations

import torch

from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL


def occ_ranks(sorted_rows: torch.Tensor) -> torch.Tensor:
    """Index within the run of equal values, for rows sorted ascending."""
    s = sorted_rows.shape[-1]
    iota = torch.arange(s, device=sorted_rows.device).expand(sorted_rows.shape)
    new_run = torch.ones(sorted_rows.shape, dtype=torch.bool, device=sorted_rows.device)
    new_run[..., 1:] = sorted_rows[..., 1:] != sorted_rows[..., :-1]
    run_start = torch.cummax(torch.where(new_run, iota, 0), dim=-1).values
    return iota - run_start


def prefix_eq_ranks(rows: torch.Tensor) -> torch.Tensor:
    """Number of equal elements before each element of an unsorted row
    ([B, W] -> [B, W]); O(W^2) per row, for short rows."""
    W = rows.shape[-1]
    eq = rows[..., None, :] == rows[..., :, None]           # [.., i, j]: x_j == x_i
    before = torch.ones((W, W), dtype=torch.bool, device=rows.device).tril(-1)
    return (eq & before).sum(dim=-1)


def sort_hashes_padded(hashes: torch.Tensor, mask: torch.Tensor):
    """Rows sorted ascending as uint64 with masked-out entries sent to
    SENTINEL, plus the valid counts [B] int32.  Unlike a sketch, zeros
    (invalid k-mers) are kept: rkmh sorts the raw array."""
    x = torch.where(mask, hashes, torch.full_like(hashes, SENTINEL))
    x = torch.sort(x ^ INT64_MIN, dim=-1).values ^ INT64_MIN
    return x, mask.sum(dim=-1, dtype=torch.int32)
