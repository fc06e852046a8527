"""Classification steps: hash -> ranks -> table probe -> argmax, per batch.

Counterpart of ``rkmh_tpu/classify/engine.py``: ``argmax_stream`` (:45),
the stream step ``classify_codes_table_packed2`` (:353),
``hash_batch_with_mask`` (:152) and the hpv16 combined-table step
(``hpv16_compact_width`` :718, ``hpv16_batch_comb`` :794).  The JAX
stream step packs its result two reads per int64 for a remote accelerator
link; here it returns int32 [3, B] (best, shared, flag bits diff_ok |
depth_fail << 1 | match_fail << 2), which the host formats as it is
fetched: there is nothing to unpack.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes, window_mask
from rkmh_tpu_torch.ops.probe import NOSORT_MAX_W, panel_probe
from rkmh_tpu_torch.ops.set_probe import set_probe
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch


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


def sketch_batch(codes: torch.Tensor, ks, sketch_size: int):
    """codes [B, L] -> (sorted bottom-s sketches [B, min(s, W)], lens [B])."""
    return bottom_s_sketch(multi_k_window_hashes(codes, ks), sketch_size)


def classify_codes_table(codes: torch.Tensor, panel, ks, sketch_size: int,
                         min_diff: int, min_matches: int) -> torch.Tensor:
    """The per-batch stream step: [B, L] uint8 codes -> int32 [3, B].

    When every window fits the sketch (W <= s) the bottom-s selection is
    the identity, so the raw hashes go to the probe with prefix-equality
    ranks and no sort (capped at NOSORT_MAX_W); otherwise the rows are
    sketched first.  Both routes give identical results."""
    hashes = multi_k_window_hashes(codes, ks)
    W = hashes.shape[-1]
    if W <= sketch_size and W <= NOSORT_MAX_W:
        return panel_probe(hashes, None, panel.table, panel.num_refs,
                           min_diff, min_matches)
    sk, lens = bottom_s_sketch(hashes, sketch_size)
    return panel_probe(sk, lens, panel.table, panel.num_refs, min_diff, min_matches)


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


def hpv16_batch_comb(codes: torch.Tensor, comb_table: torch.Tensor, ks, num_types: int,
                     num_uniq: int, Wc: int) -> torch.Tensor:
    """The hpv16 step: [B, L] uint8 codes -> int64 [B, 2+U] (best type, its
    distinct shared count, the U lineage/sublineage unique-k-mer counts)
    against the combined type + group set table.  Every window hash of a
    read is sorted (a full-width bottom_s_sketch) and cut to Wc columns."""
    hashes = multi_k_window_hashes(codes, ks)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    return set_probe(full[:, :Wc], lens, comb_table, num_types, num_uniq)
