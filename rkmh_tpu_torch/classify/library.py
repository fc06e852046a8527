"""Classification-library helpers: the equiv.hpp API surface.

Counterpart of ``rkmh_tpu/classify/library.py``.  The reference's
equiv.hpp exports more than its commands use: ``merge``,
``only_informative_kmers``, ``classify``, ``all_hash_compare``
(equiv.hpp:59-111, 171-199, 440-472) are library functions with no live
call site in rkmh.cpp.  The scalar forms below are copies of the JAX
package's, the executable spec (on the port's ``oracle``).  The batch forms
run whole row batches on tensors of either device; they are library calls
(``torch.sort``, ``torch.searchsorted``, ``torch.cumsum``), as their JAX
counterparts are (``jnp.sort``, ``searchsorted``, cumsum), and their
outputs equal the JAX package's bit for bit.

Rows are hashes as int64 bit patterns (the port's convention): 0 is the
invalid hash, SENTINEL (-1, i.e. 2**64 - 1) pads, and unsigned order is
the signed order of ``x ^ INT64_MIN``.

Semantics notes vs the reference:
* merge keeps the reference's bottom-s-of-union behavior (min_heap over
  all hashes); the counted variant reports exact multiset counts rather
  than HASHTCounter(1e8)-lossy ones (pass counter_size to reproduce the
  lossy behavior).
* classify uses multiset intersection (hash_intersection) with the
  strict-> scan starting at 0 — an unmatched read returns "" exactly
  like equiv.hpp:459-470.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from rkmh_tpu_torch import oracle
from rkmh_tpu_torch.ops.intersect import intersection_counts
from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL


def merge_sketches(mins: list[list[int]], sketch_size: int) -> list[int]:
    """Bottom-s sketch of the union of several sketches
    (equiv.hpp:88-111 merge/2): the min_heap is a std::set that skips
    zeros (equiv.hpp:32-34), so the union dedups and drops the invalid
    sentinel before taking the lowest `sketch_size`."""
    allh = sorted({h for row in mins for h in row} - {0})
    return allh[:sketch_size]


def merge_sketches_with_counts(
    mins: list[list[int]], sketch_size: int, counter_size: int | None = None
) -> tuple[list[int], list[int]]:
    """merge/3 (equiv.hpp:59-83): bottom-(2*sketch_size) union sketch
    (set semantics, zeros dropped) plus per-hash occurrence counts over
    every input element.  counter_size reproduces the reference's lossy
    HASHTCounter(1e8) counts (collisions merge); None = exact."""
    counts: Counter = Counter()
    for row in mins:
        for h in row:
            key = h % counter_size if counter_size else h
            counts[key] += 1
    sketch = merge_sketches(mins, 2 * sketch_size)  # heap is 2*s, equiv.hpp:62
    out_counts = [
        counts[h % counter_size if counter_size else h] for h in sketch
    ]
    return sketch, out_counts


def only_informative_kmers(
    name_to_hashes: dict[str, list[int]], max_samples: int
) -> dict[str, list[int]]:
    """Per-sample hash lists filtered to hashes occurring in fewer than
    max_samples samples (equiv.hpp:171-199; distinct per-sample counting
    via make_kmer_to_sample_count)."""
    sample_count: Counter = Counter()
    for hashes in name_to_hashes.values():
        for h in set(hashes):
            sample_count[h] += 1
    return {
        name: [h for h in hashes if sample_count[h] < max_samples]
        for name, hashes in name_to_hashes.items()
    }


def classify(read_hashes: list[int], ref_to_hashes: dict[str, list[int]]) -> str:
    """Best-matching reference name by multiset intersection size, "" when
    nothing matches (equiv.hpp:459-472; map iteration = sorted names)."""
    best, best_shared = "", 0
    sh = sorted(read_hashes)
    for name in sorted(ref_to_hashes):
        shared = oracle.intersection_size(sh, sorted(ref_to_hashes[name]))
        if shared > best_shared:
            best, best_shared = name, shared
    return best


def all_hash_compare(
    hashes: list[int], ref_hashes: list[tuple[str, list[int]]]
) -> list[int]:
    """Multiset intersection size vs every reference (equiv.hpp:447-456);
    ``all_hash_compare_batch`` is the batch form."""
    sh = sorted(hashes)
    return [
        oracle.intersection_size(sh, sorted(rh)) for _, rh in ref_hashes
    ]


# ---------------------------------------------------------------------------
# Batch forms of the same exports (rkmh_tpu/classify/library.py:104-197),
# bit-tested against the scalar spec and the JAX package
# (tests/test_torch_library.py).  Rows: int64 bit patterns, 0 = invalid,
# any order unless noted.
# ---------------------------------------------------------------------------


def _sort_unsigned(x: torch.Tensor) -> torch.Tensor:
    """Rows sorted ascending as uint64 along the last axis."""
    return torch.sort(x ^ INT64_MIN, dim=-1).values ^ INT64_MIN


def _searchsorted_unsigned(sorted_seq: torch.Tensor, values: torch.Tensor,
                           side: str) -> torch.Tensor:
    return torch.searchsorted(sorted_seq ^ INT64_MIN, values ^ INT64_MIN, side=side)


def _sort_flat(rows: torch.Tensor) -> torch.Tensor:
    """All valid values of [..., W] rows, ascending, SENTINEL-padded."""
    flat = rows.reshape(-1)
    return _sort_unsigned(torch.where(flat == 0, torch.full_like(flat, SENTINEL), flat))


def merge_sketches_batch(rows: torch.Tensor, sketch_size: int):
    """merge/2 (equiv.hpp:88-111): bottom-`sketch_size` of the DEDUPED
    union of all rows.  Returns (sorted [sketch_size] int64,
    SENTINEL-padded, count as an int32 scalar tensor)."""
    xs = _sort_flat(rows)
    keep = xs != SENTINEL
    keep[1:] &= xs[1:] != xs[:-1]
    rank = torch.cumsum(keep, 0) - 1
    sel = keep & (rank < sketch_size)
    out = torch.full((sketch_size,), SENTINEL, dtype=torch.int64, device=rows.device)
    out[rank[sel]] = xs[sel]
    n = torch.clamp(keep.sum(), max=sketch_size).to(torch.int32)
    return out, n


def merge_sketches_with_counts_batch(rows: torch.Tensor, sketch_size: int):
    """merge/3 (equiv.hpp:59-83): bottom-(2*sketch_size) union sketch plus
    exact multiset occurrence counts per selected hash (the
    counter_size=None flavor of merge_sketches_with_counts)."""
    sketch, n = merge_sketches_batch(rows, 2 * sketch_size)
    xs = _sort_flat(rows)
    cnt = (_searchsorted_unsigned(xs, sketch, "right")
           - _searchsorted_unsigned(xs, sketch, "left"))
    counts = torch.where(sketch != SENTINEL, cnt, 0).to(torch.int32)
    return sketch, counts, n


def informative_mask_batch(rows: torch.Tensor, sample_counts_max: int) -> torch.Tensor:
    """only_informative_kmers (equiv.hpp:171-199): per-element keep mask
    for hashes occurring in fewer than `sample_counts_max` DISTINCT rows
    (invalid 0s are never kept).

    Counting: row-sort -> per-row first-occurrence flags -> one global
    sort of the distinct stream -> run lengths = samples per hash ->
    searchsorted lookup back onto every original element."""
    x = torch.where(rows == 0, torch.full_like(rows, SENTINEL), rows)
    xs = _sort_unsigned(x)
    row_first = torch.ones_like(xs, dtype=torch.bool)
    row_first[:, 1:] = xs[:, 1:] != xs[:, :-1]
    distinct = torch.where(row_first & (xs != SENTINEL), xs, torch.zeros_like(xs))
    ds = _sort_flat(distinct)
    n_samples = (_searchsorted_unsigned(ds, x, "right")
                 - _searchsorted_unsigned(ds, x, "left"))
    return (rows != 0) & (n_samples < sample_counts_max)


def all_hash_compare_batch(read_sorted: torch.Tensor, read_lens: torch.Tensor,
                           ref_sorted: torch.Tensor, ref_lens: torch.Tensor) -> torch.Tensor:
    """all_hash_compare (equiv.hpp:447-456): multiset intersection sizes
    [B, R] int32 of sorted hash rows (SENTINEL-padded, as
    ``ops.intersect.sort_hashes_padded`` makes them)."""
    return intersection_counts(read_sorted, read_lens, ref_sorted, ref_lens)


def classify_batch(read_sorted: torch.Tensor, read_lens: torch.Tensor,
                   ref_sorted: torch.Tensor, ref_lens: torch.Tensor,
                   ref_names: list[str]) -> list[str]:
    """classify (equiv.hpp:459-472) over a read batch: best NAME-SORTED
    reference per read by multiset intersection, "" when nothing matches
    (the reference iterates a std::map, i.e. sorted names, with a strict >
    scan)."""
    order = np.argsort(ref_names, kind="stable")
    at = torch.from_numpy(order).to(ref_sorted.device)
    counts = all_hash_compare_batch(read_sorted, read_lens, ref_sorted[at],
                                    ref_lens[at]).cpu().numpy()
    best = counts.argmax(axis=1)
    names_sorted = [ref_names[i] for i in order]
    return [
        names_sorted[b] if counts[i, b] > 0 else ""
        for i, b in enumerate(best)
    ]
