"""Occurrence ranks: each sketch element's index within its run of equal
values, which the panel probe pairs with the value.

Counterpart of ``rkmh_tpu/ops/intersect.py::occ_ranks`` (:35) for sorted
rows, and of the sort-free prefix-equality count of
``rkmh_tpu/classify/engine.py:306-311`` for unsorted rows.  Both give the
same multiset of (value, rank) pairs for a row, so the probe counts agree.
Also ``sort_hashes_padded`` (``rkmh_tpu/ops/intersect.py:122``) and
``intersection_counts`` (:75, with ``_chunked_ref_map`` :58), the batched
multiset intersection sizes that ``classify.library`` exports.
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


def _ref_chunk(B: int, s: int, target_bytes: int = 1 << 26) -> int:
    """References a step, so that a step's searches stay near target_bytes."""
    return max(1, min(64, target_bytes // max(B * s * 8, 1)))


def intersection_counts(read_sk: torch.Tensor, read_lens: torch.Tensor, ref_sk: torch.Tensor,
                        ref_lens: torch.Tensor | None = None) -> torch.Tensor:
    """[B, s] sorted read sketches vs [R, t] sorted reference sketches ->
    [B, R] int32 multiset intersection sizes (min multiplicity; SENTINEL
    padding never counts).

    For each read element, two binary searches in the reference row give
    the count cb of its value there; the element counts when its rank in its
    run of equal values is below cb, so a value ca times in the read and cb
    times in the reference adds min(ca, cb).  Unsigned order is the signed
    order of ``x ^ INT64_MIN``.  References go ``_ref_chunk`` at a time,
    as ``_chunked_ref_map`` bounds the JAX package's memory.  ``ref_lens``
    is accepted for symmetry: SENTINEL padding needs no lengths."""
    B, s = read_sk.shape
    R = ref_sk.shape[0]
    occ = occ_ranks(read_sk)
    qmask = (torch.arange(s, device=read_sk.device)[None, :] < read_lens[:, None].long()) & (
        read_sk != SENTINEL)
    q = (read_sk ^ INT64_MIN).reshape(1, B * s)
    out = torch.zeros((R, B), dtype=torch.int32, device=read_sk.device)
    chunk = _ref_chunk(B, s)
    for r0 in range(0, R, chunk):
        rows = (ref_sk[r0: r0 + chunk] ^ INT64_MIN).contiguous()
        qs = q.expand(rows.shape[0], -1).contiguous()
        cb = (torch.searchsorted(rows, qs, side="right")
              - torch.searchsorted(rows, qs, side="left")).reshape(-1, B, s)
        out[r0: r0 + chunk] = ((occ < cb) & qmask).sum(dim=-1, dtype=torch.int32)
    return out.T.contiguous()
