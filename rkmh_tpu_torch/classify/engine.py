"""Classification steps: hash -> ranks -> table probe -> argmax, per batch.

Counterpart of ``rkmh_tpu/classify/engine.py``: ``argmax_stream`` (:45),
``argmax_filter`` (:56), the stream step ``classify_codes_table_packed2``
(:353) and its -M form (``sketch_batch_depth_filtered`` :159 then
``classify_sketches_table_packed2`` :524), the filter step
``filter_sketches_table_packed`` (:886), ``hash_batch_with_mask`` (:152),
``sketch_batch_informative`` (:171), ``distinct_hash_mask`` (:909) and the
hpv16 combined-table step (``hpv16_compact_width`` :718,
``hpv16_batch_comb`` :794, with -M) and its sorted-panel fallback
(``hpv16_sorted_batch`` :865).  The JAX stream step packs its result
two reads per int64 for a remote accelerator link; here it returns int32
[3, B] (best, shared, flag bits diff_ok | depth_fail << 1 | match_fail <<
2), which the host formats as it is fetched: there is nothing to unpack.
The filter step returns int32 [5, B] (``ops/probe.pack_filter_result``).

A step given a read counter (``-M``) zeroes the hashes whose counted depth
is below ``min_occ`` before it sketches them (``ops/counter.counter_mask``).
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.ops.counter import INT32_MAX, counter_mask
from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes, window_mask
from rkmh_tpu_torch.ops.intersect import occ_ranks, sort_hashes_padded
from rkmh_tpu_torch.ops.probe import NOSORT_MAX_W, panel_probe, panel_probe_filter
from rkmh_tpu_torch.ops.set_probe import set_probe
from rkmh_tpu_torch.ops.sketch import SENTINEL, bottom_s_sketch
from rkmh_tpu_torch.ops.sorted_probe import sorted_probe


def argmax_stream(counts: torch.Tensor, min_diff: int, min_matches: int,
                  sketch_lens: torch.Tensor):
    """rkmh stream semantics (rkmh.cpp:874-889) -> (best, max_shared,
    diff_ok, depth_fail, match_fail).

    The running max starts at -1 and updates on a strict ``>``, so the
    first reference wins ties (``torch.argmax`` returns the first maximal
    index); diff is max_shared minus max(-1, max(counts[:best]))."""
    max_shared = counts.amax(dim=-1)
    best = counts.argmax(dim=-1)
    iota = torch.arange(counts.shape[-1], device=counts.device)
    pm = torch.where(iota[None, :] < best[:, None], counts,
                     torch.full_like(counts, -1)).amax(dim=-1)
    diff_ok = (max_shared - pm) > min_diff          # True = no FAIL:DIFF
    depth_fail = sketch_lens <= min_matches         # FAIL:DEPTH tag
    match_fail = max_shared < min_matches           # FAIL:MATCHES tag
    return best, max_shared, diff_ok, depth_fail, match_fail


def argmax_filter(counts: torch.Tensor, min_diff: int, min_matches: int,
                  sketch_lens: torch.Tensor, ref_lens: torch.Tensor):
    """rkmh filter semantics (equiv.hpp:324-353) -> (best or -1, shared,
    total_union, keep, depth_fail, match_fail, diff_ok).

    The running max starts at 0, so a read that shares nothing gets best
    -1 and shared 0; total_union = min(sketch_len, ref_lens[best]) when
    some count exceeded 0, 0 otherwise; depth fails at sketch_len <= 0."""
    max_shared = counts.amax(dim=-1)
    best_raw = counts.argmax(dim=-1)
    iota = torch.arange(counts.shape[-1], device=counts.device)
    pm = torch.where(iota[None, :] < best_raw[:, None], counts,
                     torch.zeros_like(counts)).amax(dim=-1)
    updated = max_shared > 0
    best = torch.where(updated, best_raw, -1)
    shared = torch.where(updated, max_shared, 0)
    tu = torch.where(updated, torch.minimum(sketch_lens, ref_lens[best_raw]), 0)
    diff_ok = (shared - torch.where(updated, pm, 0)) > min_diff
    depth_fail = sketch_lens <= 0                  # rkmh.cpp:1292/1394
    match_fail = shared < min_matches              # rkmh.cpp:1293/1395
    keep = ~depth_fail & ~match_fail & diff_ok
    return best, shared, tu, keep, depth_fail, match_fail, diff_ok


def sketch_batch(codes: torch.Tensor, ks, sketch_size: int):
    """codes [B, L] -> (sorted bottom-s sketches [B, min(s, W)], lens [B])."""
    return bottom_s_sketch(multi_k_window_hashes(codes, ks), sketch_size)


def depth_filtered_hashes(codes: torch.Tensor, ks, counter: torch.Tensor | None = None,
                          min_occ: int = 0) -> torch.Tensor:
    """Window hashes, those counted below min_occ in ``counter`` (a read
    counter's table; None: no -M) zeroed."""
    hashes = multi_k_window_hashes(codes, ks)
    return hashes if counter is None else counter_mask(counter, hashes, min_occ, INT32_MAX)


def sketch_batch_depth_filtered(codes: torch.Tensor, counter: torch.Tensor, ks,
                                sketch_size: int, min_occ: int):
    """stream/filter -M read sketches (rkmh.cpp:903-917): hash, zero the
    hashes counted below min_occ, then bottom-s sketch."""
    return bottom_s_sketch(depth_filtered_hashes(codes, ks, counter, min_occ), sketch_size)


def sketch_batch_informative(codes: torch.Tensor, counter: torch.Tensor, ks,
                             sketch_size: int, max_occ: int):
    """-I reference sketches (rkmh.cpp:829-837): keep the hashes counted
    at most max_occ times, then bottom-s sketch."""
    hashes = counter_mask(counter, multi_k_window_hashes(codes, ks), 0, max_occ)
    return bottom_s_sketch(hashes, sketch_size)


def distinct_hash_mask(codes: torch.Tensor, lengths: torch.Tensor, ks):
    """(rows sorted as uint64 with padding windows sent to SENTINEL, mask
    of the first occurrence of each value in its row).  Filter -I counts
    each hash once per reference (rkmh.cpp:340-357); the 0 of invalid
    k-mers counts once too, as rkmh's set holds it."""
    x, _ = sort_hashes_padded(multi_k_window_hashes(codes, ks),
                              window_mask(lengths, codes.shape[-1], ks))
    return x, (occ_ranks(x) == 0) & (x != SENTINEL)


def probe_rows(hashes: torch.Tensor, sketch_size: int):
    """-> (rows, lens) for the panel probe.  When every window fits the
    sketch (W <= s) the bottom-s selection is the identity, so the raw
    hashes go to the probe with prefix-equality ranks and no sort (lens
    None; capped at NOSORT_MAX_W); otherwise the rows are sketched first.
    Both routes give identical results."""
    W = hashes.shape[-1]
    if W <= sketch_size and W <= NOSORT_MAX_W:
        return hashes, None
    return bottom_s_sketch(hashes, sketch_size)


def classify_codes_table(codes: torch.Tensor, panel, ks, sketch_size: int,
                         min_diff: int, min_matches: int,
                         counter: torch.Tensor | None = None, min_occ: int = 0) -> torch.Tensor:
    """The per-batch stream step: [B, L] uint8 codes -> int32 [3, B]."""
    rows, lens = probe_rows(depth_filtered_hashes(codes, ks, counter, min_occ), sketch_size)
    return panel_probe(rows, lens, panel.table, panel.num_refs, min_diff, min_matches)


def filter_codes_table(codes: torch.Tensor, panel, ks, sketch_size: int,
                       min_diff: int, min_matches: int,
                       counter: torch.Tensor | None = None, min_occ: int = 0) -> torch.Tensor:
    """The per-batch filter step: [B, L] uint8 codes -> int32 [5, B]
    (best, shared, total_union, keep, flags)."""
    rows, lens = probe_rows(depth_filtered_hashes(codes, ks, counter, min_occ), sketch_size)
    return panel_probe_filter(rows, lens, panel.table, panel.num_refs, panel.lens,
                              min_diff, min_matches)


def hash_batch_with_mask(codes: torch.Tensor, lengths: torch.Tensor, ks):
    """Window hashes [B, W] int64 plus the mask of windows that exist in
    the unpadded reads."""
    return multi_k_window_hashes(codes, ks), window_mask(lengths, codes.shape[-1], ks)


def hpv16_compact_width(lens, L: int, ks, grid: int = 8) -> int:
    """Host-side probe width of an hpv16 batch: the largest multi-k window
    count sum_k max(len - k + 1, 0) over its reads (unpadded lengths),
    rounded up to W/grid quanta.  A row's valid hashes sort into a prefix
    no longer than its window count, so cutting the sorted rows to this
    width drops only padding."""
    W = sum(max(L - k + 1, 0) for k in ks)
    lens = np.asarray(lens)
    need = sum(int(np.max(np.maximum(lens - (k - 1), 0), initial=0)) for k in ks)
    if need >= W:
        return W
    q = max(1, -(-W // grid))
    return min(W, max(q, -(-need // q) * q))


def hpv16_batch_comb(codes: torch.Tensor, comb_table, ks, num_types: int,
                     num_uniq: int, Wc: int, counter: torch.Tensor | None = None,
                     min_occ: int = 0) -> torch.Tensor:
    """The hpv16 step: [B, L] uint8 codes -> int64 [B, 2+U] (best type, its
    distinct shared count, the U lineage/sublineage unique-k-mer counts)
    against the combined type + group set table (on a GPU its
    ``ops/set_probe.PackedSetTable``).  Every window hash of a
    read (with -M, those counted at least min_occ times) is sorted (a
    full-width bottom_s_sketch) and cut to Wc columns."""
    hashes = depth_filtered_hashes(codes, ks, counter, min_occ)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    return set_probe(full[:, :Wc], lens, comb_table, num_types, num_uniq)


def hpv16_sorted_batch(codes: torch.Tensor, panel, ks, num_types: int, num_uniq: int,
                       Wc: int, counter: torch.Tensor | None = None,
                       min_occ: int = 0) -> torch.Tensor:
    """The hpv16 step against the sorted-key panel (``ops/sorted_probe
    .SortedPanel``), the fallback past the set-table cap: as
    ``hpv16_batch_comb``, with the sorted probe in place of the set-table
    probe; the same int64 [B, 2+U] result."""
    hashes = depth_filtered_hashes(codes, ks, counter, min_occ)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    return sorted_probe(full[:, :Wc], lens, panel, num_types, num_uniq)
