"""Classification step: hash -> ranks -> panel probe -> argmax, per batch.

Counterpart of ``rkmh_tpu/classify/engine.py``: ``argmax_stream`` (:45)
and the stream step ``classify_codes_table_packed2`` (:353).  The JAX step
packs its result two reads per int64 for a remote accelerator link; here
the step returns int32 [3, B] (best, shared, flag bits diff_ok |
depth_fail << 1 | match_fail << 2), which the host formats as it is
fetched: there is nothing to unpack.
"""

from __future__ import annotations

import torch

from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
from rkmh_tpu_torch.ops.probe import NOSORT_MAX_W, panel_probe
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

