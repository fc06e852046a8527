"""The fused panel probe: sketch rows -> per-read (best, shared, flags).

One call runs, per read, the occurrence ranks, the bucket-table probe,
the per-reference counts and the argmax.  On a CUDA tensor it is the
panel-probe kernel (``csrc/panel_probe.cu``): K2 up to MAX_REFS
references, K11, its wide route without per-reference counters, past
them; on a CPU tensor it is
``panel_probe_plain``, the composition of the plain ports of the JAX
package's functions (``ops/intersect``, ``ops/lookup``,
``classify/engine.argmax_stream``), which the kernel must match exactly.
``panel_probe_filter`` is the same probe with the filter command's
epilogue (``classify/engine.argmax_filter``); its plain version is
``panel_probe_filter_plain``.

Rows are [B, n] int64 hashes in one of two modes:

* ``lens is None``: raw window hashes, used when W <= s; valid = h != 0,
  ranks by prefix equality;
* ``lens`` given: sorted bottom-s sketches; valid = i < len and
  h != SENTINEL, ranks within runs.
"""

from __future__ import annotations

import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.intersect import occ_ranks, prefix_eq_ranks
from rkmh_tpu_torch.ops.lookup import lookup_intersection_counts_masked, table_slots
from rkmh_tpu_torch.ops.sketch import SENTINEL

# raw-hash mode cap on W: the plain version's ranks cost O(W^2) per read;
# longer rows take the sorted-sketch mode (the JAX package's NOSORT_MAX_W,
# engine.py:290)
NOSORT_MAX_W = 256
# past 256 references K2's counters live in shared memory, 32 * ceil(R/32)
# ints per read; past MAX_REFS the panel takes K11
MAX_REFS = 8192
_SMEM_BYTES = 232448 - 1024  # a block's shared memory on sm_90, less static use


def pack_result(best, shared, diff_ok, depth_fail, match_fail) -> torch.Tensor:
    """argmax_stream's outputs -> int32 [3, B] (best, shared, flag bits
    diff_ok | depth_fail << 1 | match_fail << 2)."""
    flags = diff_ok.to(torch.int32) | (depth_fail.to(torch.int32) << 1) | (
        match_fail.to(torch.int32) << 2)
    return torch.stack([best.to(torch.int32), shared.to(torch.int32), flags])


def pack_filter_result(best, shared, total_union, keep, depth_fail, match_fail,
                       diff_ok) -> torch.Tensor:
    """argmax_filter's outputs -> int32 [5, B] (best, shared, total_union,
    keep, flag bits depth_fail | match_fail << 1 | diff_ok << 2), the
    layout of ``rkmh_tpu/classify/engine.py:886-906``."""
    flags = depth_fail.to(torch.int32) | (match_fail.to(torch.int32) << 1) | (
        diff_ok.to(torch.int32) << 2)
    return torch.stack([t.to(torch.int32) for t in (best, shared, total_union, keep)]
                       + [flags])


def _plain_counts(rows, lens, table, num_refs):
    """-> ([B, R] counts, [B] sketch lengths) in either row mode."""
    if lens is None:
        valid = rows != 0
        occ = prefix_eq_ranks(rows)
        sk_lens = valid.sum(dim=-1, dtype=torch.int32)
    else:
        n = rows.shape[-1]
        valid = (torch.arange(n, device=rows.device)[None, :] < lens[:, None]) & (
            rows != SENTINEL)
        occ = occ_ranks(rows)
        sk_lens = lens
    return lookup_intersection_counts_masked(rows, valid, occ, table, num_refs), sk_lens


def panel_probe_plain(rows: torch.Tensor, lens: torch.Tensor | None, table: torch.Tensor,
                      num_refs: int, min_diff: int, min_matches: int) -> torch.Tensor:
    from rkmh_tpu_torch.classify.engine import argmax_stream

    counts, sk_lens = _plain_counts(rows, lens, table, num_refs)
    return pack_result(*argmax_stream(counts, min_diff, min_matches, sk_lens))


def panel_probe_filter_plain(rows: torch.Tensor, lens: torch.Tensor | None,
                             table: torch.Tensor, num_refs: int, ref_lens: torch.Tensor,
                             min_diff: int, min_matches: int) -> torch.Tensor:
    from rkmh_tpu_torch.classify.engine import argmax_filter

    counts, sk_lens = _plain_counts(rows, lens, table, num_refs)
    return pack_filter_result(*argmax_filter(counts, min_diff, min_matches, sk_lens,
                                             ref_lens))


def _cuda_args(rows, lens, table, num_refs, wide: bool):
    """Checks what the kernel takes; -> (rows, lens, table, log2 buckets,
    slots, mask words), contiguous.  K11 (``wide``) keeps a list of a row's
    hits in shared memory in place of K2's counters."""
    if rows.dtype != torch.int64 or rows.dim() != 2:
        raise ValueError(f"panel probe takes [B, n] int64 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.device != rows.device:
        raise ValueError("panel probe takes an int32 [NB, width] table on the rows' device")
    if num_refs < 1 or (not wide and num_refs > MAX_REFS):
        raise ValueError(f"panel probe kernel K2 holds 1..{MAX_REFS} per-reference "
                         f"counters in shared memory, got {num_refs} references")
    nb = table.shape[0]
    if nb & (nb - 1):
        raise ValueError(f"bucket count {nb} is not a power of two")
    B, n = rows.shape
    S = table_slots(table.shape[1], num_refs)
    Wm = table.shape[1] // S - 3
    # per read: raw rows need >= n ranks-table slots of 8 bytes; past 256
    # references K2's counters go to shared memory too, and K11's hit list
    extra = n * 8 if wide else Wm * 128 if Wm > 8 else 0
    if (n * 8 if lens is None else 0) + extra > _SMEM_BYTES:
        raise ValueError(f"panel probe kernel: the shared memory of a row of {n} hashes "
                         f"at {num_refs} references does not fit")
    rows = rows.contiguous()
    table = table.contiguous()
    if lens is not None:
        if lens.shape != (B,) or lens.device != rows.device:
            raise ValueError("lens must be [B] on the rows' device")
        lens = lens.to(torch.int32).contiguous()
    return rows, lens, table, nb.bit_length() - 1, S, Wm


def _panel_probe_cuda(rows, lens, table, num_refs, min_diff, min_matches, wide=None):
    """K2, or K11 where ``wide`` (default: num_refs > MAX_REFS)."""
    wide = num_refs > MAX_REFS if wide is None else wide
    rows, lens, table, log2nb, S, Wm = _cuda_args(rows, lens, table, num_refs, wide)
    B, n = rows.shape
    out = torch.empty((3, B), dtype=torch.int32, device=rows.device)
    if B and wide:
        kernels.PANEL_PROBE_WIDE(rows, lens, B, n, table, log2nb, S, Wm, num_refs, None,
                                 min_diff, min_matches, out, route="stream")
    elif B:
        kernels.PANEL_PROBE(rows, lens, B, n, table, log2nb, S, Wm, num_refs, min_diff,
                            min_matches, out)
    return out


def _panel_probe_filter_cuda(rows, lens, table, num_refs, ref_lens, min_diff, min_matches,
                             wide=None):
    """K2's filter epilogue, or K11's where ``wide`` (default: num_refs >
    MAX_REFS)."""
    wide = num_refs > MAX_REFS if wide is None else wide
    rows, lens, table, log2nb, S, Wm = _cuda_args(rows, lens, table, num_refs, wide)
    if ref_lens.shape != (num_refs,) or ref_lens.device != rows.device:
        raise ValueError("ref_lens must be [num_refs] on the rows' device")
    ref_lens = ref_lens.to(torch.int32).contiguous()
    B, n = rows.shape
    out = torch.empty((5, B), dtype=torch.int32, device=rows.device)
    if B and wide:
        kernels.PANEL_PROBE_WIDE(rows, lens, B, n, table, log2nb, S, Wm, num_refs, ref_lens,
                                 min_diff, min_matches, out, route="filter")
    elif B:
        kernels.PANEL_PROBE_FILTER(rows, lens, B, n, table, log2nb, S, Wm, num_refs,
                                   ref_lens, min_diff, min_matches, out)
    return out


def panel_probe(rows: torch.Tensor, lens: torch.Tensor | None, table: torch.Tensor,
                num_refs: int, min_diff: int, min_matches: int) -> torch.Tensor:
    """[B, n] int64 rows -> int32 [3, B] (best, shared, flags)."""
    if rows.device.type == "cuda":
        return _panel_probe_cuda(rows, lens, table, num_refs, min_diff, min_matches)
    if rows.device.type != "cpu":
        raise ValueError(f"no panel-probe path for device {rows.device}")
    return panel_probe_plain(rows, lens, table, num_refs, min_diff, min_matches)


def panel_probe_filter(rows: torch.Tensor, lens: torch.Tensor | None, table: torch.Tensor,
                       num_refs: int, ref_lens: torch.Tensor, min_diff: int,
                       min_matches: int) -> torch.Tensor:
    """[B, n] int64 rows + the references' sketch lengths [R] -> int32
    [5, B] (best, shared, total_union, keep, flags)."""
    if rows.device.type == "cuda":
        return _panel_probe_filter_cuda(rows, lens, table, num_refs, ref_lens, min_diff,
                                        min_matches)
    if rows.device.type != "cpu":
        raise ValueError(f"no panel-probe path for device {rows.device}")
    return panel_probe_filter_plain(rows, lens, table, num_refs, ref_lens, min_diff,
                                    min_matches)
