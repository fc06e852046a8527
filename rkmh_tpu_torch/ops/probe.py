"""The fused panel probe: sketch rows -> per-read (best, shared, flags).

One call runs, per read, the occurrence ranks, the bucket-table probe,
the per-reference counts and the stream argmax.  On a CUDA tensor it is
the panel-probe kernel (``csrc/panel_probe.cu``); on a CPU tensor it is
``panel_probe_plain``, the composition of the plain ports of the JAX
package's functions (``ops/intersect``, ``ops/lookup``,
``classify/engine.argmax_stream``), which the kernel must match exactly.

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

# raw-hash mode cap on W: its ranks cost O(W^2) per read; longer rows take
# the sorted-sketch mode (the JAX package's NOSORT_MAX_W, engine.py:290)
NOSORT_MAX_W = 256
# per-reference counters live in shared memory: 32 * ceil(R/32) ints
MAX_REFS = 8192
_SMEM_BYTES = 232448 - 1024  # a block's shared memory on sm_90, less static use


def pack_result(best, shared, diff_ok, depth_fail, match_fail) -> torch.Tensor:
    """argmax_stream's outputs -> int32 [3, B] (best, shared, flag bits
    diff_ok | depth_fail << 1 | match_fail << 2)."""
    flags = diff_ok.to(torch.int32) | (depth_fail.to(torch.int32) << 1) | (
        match_fail.to(torch.int32) << 2)
    return torch.stack([best.to(torch.int32), shared.to(torch.int32), flags])


def panel_probe_plain(rows: torch.Tensor, lens: torch.Tensor | None, table: torch.Tensor,
                      num_refs: int, min_diff: int, min_matches: int) -> torch.Tensor:
    from rkmh_tpu_torch.classify.engine import argmax_stream

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
    counts = lookup_intersection_counts_masked(rows, valid, occ, table, num_refs)
    return pack_result(*argmax_stream(counts, min_diff, min_matches, sk_lens))


def _panel_probe_cuda(rows, lens, table, num_refs, min_diff, min_matches):
    if rows.dtype != torch.int64 or rows.dim() != 2:
        raise ValueError(f"panel probe takes [B, n] int64 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.device != rows.device:
        raise ValueError("panel probe takes an int32 [NB, width] table on the rows' device")
    if not 1 <= num_refs <= MAX_REFS:
        raise ValueError(f"panel probe kernel holds 1..{MAX_REFS} per-reference "
                         f"counters in shared memory, got {num_refs} references")
    nb = table.shape[0]
    if nb & (nb - 1):
        raise ValueError(f"bucket count {nb} is not a power of two")
    B, n = rows.shape
    S = table_slots(table.shape[1], num_refs)
    Wm = table.shape[1] // S - 3
    if n * 8 + Wm * 128 > _SMEM_BYTES:
        raise ValueError(f"panel probe kernel: a row of {n} hashes does not fit "
                         "in shared memory")
    rows = rows.contiguous()
    table = table.contiguous()
    if lens is not None:
        if lens.shape != (B,) or lens.device != rows.device:
            raise ValueError("lens must be [B] on the rows' device")
        lens = lens.to(torch.int32).contiguous()
    out = torch.empty((3, B), dtype=torch.int32, device=rows.device)
    if B:
        kernels.PANEL_PROBE(rows, lens, B, n, table, nb.bit_length() - 1, S, Wm,
                            num_refs, min_diff, min_matches, out)
    return out


def panel_probe(rows: torch.Tensor, lens: torch.Tensor | None, table: torch.Tensor,
                num_refs: int, min_diff: int, min_matches: int) -> torch.Tensor:
    """[B, n] int64 rows -> int32 [3, B] (best, shared, flags)."""
    if rows.device.type == "cuda":
        return _panel_probe_cuda(rows, lens, table, num_refs, min_diff, min_matches)
    if rows.device.type != "cpu":
        raise ValueError(f"no panel-probe path for device {rows.device}")
    return panel_probe_plain(rows, lens, table, num_refs, min_diff, min_matches)
