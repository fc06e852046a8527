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

Past MAX_REFS the card takes the table in K11's own layout, ``WideTable``,
made once per run from the logical table by ``pack_wide_table`` (on the
host, so that only the packed form is copied: ``device_table``): per slot
one 16-byte record (lo, occ, hi, entry id), and the mask words of the
occupied slots as contiguous rows.  ``panel_probe_wide_packed_plain``
probes that layout in plain PyTorch; ``panel_probe`` and
``panel_probe_filter`` take it on the CPU too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.intersect import occ_ranks, prefix_eq_ranks
from rkmh_tpu_torch.ops.lookup import (
    M32,
    bucket_indices,
    lookup_intersection_counts_masked,
    table_slots,
)
from rkmh_tpu_torch.ops.sketch import SENTINEL

# raw-hash mode cap on W: the plain version's ranks cost O(W^2) per read;
# longer rows take the sorted-sketch mode (the JAX package's NOSORT_MAX_W,
# engine.py:290)
NOSORT_MAX_W = 256
# past 256 references K2's counters live in shared memory, 32 * ceil(R/32)
# ints per read; past MAX_REFS the panel takes K11
MAX_REFS = 8192
_SMEM_BYTES = 232448 - 1024  # a block's shared memory on sm_90, less static use
_EMPTY = -1        # an empty slot: occ 0xFFFFFFFF in an int32 lane, entry id -1
ROW_WORDS = 32     # K11's mask rows are padded to whole 128-byte lines
_PLAIN_BITS = 1 << 26  # the packed plain version expands this many hit bits a step


@dataclass
class WideTable:
    """A panel table in K11's layout.  ``slots`` [NB * S, 4] int32: per
    slot (bucket-major) its lo, occ, hi and entry id (-1 and occ
    0xFFFFFFFF where empty); ``rows`` [E, P] int32: the Wm mask words of
    entry e, then zeros to P = ROW_WORDS * ceil(Wm / ROW_WORDS)."""

    slots: torch.Tensor
    rows: torch.Tensor
    num_slots: int
    mask_words: int
    num_refs: int

    @property
    def device(self) -> torch.device:
        return self.slots.device

    @property
    def num_buckets(self) -> int:
        return self.slots.shape[0] // self.num_slots

    @property
    def nbytes(self) -> int:
        return 4 * (self.slots.numel() + self.rows.numel())

    def to(self, device) -> "WideTable":
        return WideTable(self.slots.to(device), self.rows.to(device), self.num_slots,
                         self.mask_words, self.num_refs)


def pack_wide_table(table: torch.Tensor, num_refs: int) -> WideTable:
    """The logical table [NB, S * (3 + Wm)] int32 -> its ``WideTable`` on
    the same device, in plain torch ops.  Made once per run, never per
    call."""
    nb, width = table.shape
    S = table_slots(width, num_refs)
    Wm = width // S - 3
    lanes = table.view(nb, 3 + Wm, S)
    bucket, slot = (lanes[:, 2] != _EMPTY).nonzero(as_tuple=True)
    E = bucket.numel()
    entry = torch.full((nb, S), _EMPTY, dtype=torch.int32, device=table.device)
    entry[bucket, slot] = torch.arange(E, dtype=torch.int32, device=table.device)
    slots = torch.stack([lanes[:, 1], lanes[:, 2], lanes[:, 0], entry], dim=-1)
    rows = torch.zeros((E, ROW_WORDS * -(-Wm // ROW_WORDS)), dtype=torch.int32,
                       device=table.device)
    rows[:, :Wm] = lanes[bucket, 3:, slot]
    return WideTable(slots.reshape(nb * S, 4), rows, S, Wm, num_refs)


def device_table(table, num_refs: int, device):
    """A host-built logical table (numpy int32 or a CPU tensor) -> what the
    probe takes on ``device``: past MAX_REFS on a GPU its ``WideTable``,
    packed on the host and copied alone; else the logical table."""
    t = torch.from_numpy(table) if isinstance(table, np.ndarray) else table
    if torch.device(device).type == "cuda" and num_refs > MAX_REFS:
        return pack_wide_table(t, num_refs).to(device)
    return t.to(device)


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


def _valid_and_ranks(rows, lens):
    """-> (valid mask, occurrence ranks, [B] sketch lengths) in either row mode."""
    if lens is None:
        valid = rows != 0
        return valid, prefix_eq_ranks(rows), valid.sum(dim=-1, dtype=torch.int32)
    n = rows.shape[-1]
    valid = (torch.arange(n, device=rows.device)[None, :] < lens[:, None]) & (rows != SENTINEL)
    return valid, occ_ranks(rows), lens


def _plain_counts(rows, lens, table, num_refs):
    """-> ([B, R] counts, [B] sketch lengths) in either row mode."""
    valid, occ, sk_lens = _valid_and_ranks(rows, lens)
    return lookup_intersection_counts_masked(rows, valid, occ, table, num_refs), sk_lens


def wide_hits(rows: torch.Tensor, valid: torch.Tensor, occ: torch.Tensor,
              wide: WideTable) -> torch.Tensor:
    """[B, n] int64 entry ids of the valid (hash, occ) pairs in ``wide``
    (-1 where missed), probed as K11 probes: the first slot of the bucket
    whose lo and occ match, then its hi."""
    lo, hi, o = rows & M32, (rows >> 32) & M32, occ.to(torch.int64)
    S = wide.num_slots
    bucket = bucket_indices(lo, hi, o, wide.num_buckets)
    rec = wide.slots.view(-1, S, 4)[bucket].to(torch.int64) & M32  # [B, n, S, 4]
    match = (rec[..., 0] == lo[..., None]) & (rec[..., 1] == o[..., None])
    first = rec.gather(-2, match.to(torch.int8).argmax(dim=-1)[..., None, None]
                       .expand(*match.shape[:-1], 1, 4))[..., 0, :]
    ok = valid & match.any(dim=-1) & (first[..., 2] == hi)
    return torch.where(ok, first[..., 3], torch.full_like(first[..., 3], -1))


def wide_counts(rows: torch.Tensor, valid: torch.Tensor, occ: torch.Tensor,
                wide: WideTable) -> torch.Tensor:
    """[B, R] int32 counts from ``wide``: each hit adds its entry's mask
    row, bit by bit, to its read's counts."""
    B, R, Wm = rows.shape[0], wide.num_refs, wide.mask_words
    e = wide_hits(rows, valid, occ, wide)
    read, at = (e >= 0).nonzero(as_tuple=True)
    ent = e[read, at]
    counts = torch.zeros((B, 32 * Wm), dtype=torch.int32, device=rows.device)
    shifts = torch.arange(32, device=rows.device)
    step = max(1, _PLAIN_BITS // (32 * Wm))
    for h0 in range(0, ent.numel(), step):
        words = wide.rows[ent[h0 : h0 + step], :Wm].to(torch.int64) & M32  # [h, Wm]
        bits = ((words[..., None] >> shifts) & 1).to(torch.int32).reshape(words.shape[0], -1)
        counts.index_add_(0, read[h0 : h0 + step], bits)
    return counts[:, :R]


def panel_probe_wide_packed_plain(rows: torch.Tensor, lens: torch.Tensor | None,
                                  wide: WideTable, num_refs: int, min_diff: int,
                                  min_matches: int,
                                  ref_lens: torch.Tensor | None = None) -> torch.Tensor:
    """K11's function on its own layout in plain PyTorch: ``argmax_stream``'s
    int32 [3, B] result, or with ``ref_lens`` ``argmax_filter``'s [5, B]."""
    from rkmh_tpu_torch.classify.engine import argmax_filter, argmax_stream

    if not isinstance(wide, WideTable) or wide.num_refs != num_refs:
        raise ValueError(f"the packed plain version takes a WideTable of {num_refs} references")
    valid, occ, sk_lens = _valid_and_ranks(rows, lens)
    counts = wide_counts(rows, valid, occ, wide)
    if ref_lens is None:
        return pack_result(*argmax_stream(counts, min_diff, min_matches, sk_lens))
    return pack_filter_result(*argmax_filter(counts, min_diff, min_matches, sk_lens, ref_lens))


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
    """Checks what the kernel takes; -> (rows, lens, log2 buckets, slots,
    mask words), contiguous.  K2 takes the logical table, K11 (``wide``)
    its ``WideTable`` and keeps a list of a row's hits in shared memory in
    place of K2's counters."""
    if rows.dtype != torch.int64 or rows.dim() != 2:
        raise ValueError(f"panel probe takes [B, n] int64 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if num_refs < 1 or (not wide and num_refs > MAX_REFS):
        raise ValueError(f"panel probe kernel K2 holds 1..{MAX_REFS} per-reference "
                         f"counters in shared memory, got {num_refs} references")
    if wide:
        if not isinstance(table, WideTable):
            raise ValueError("K11 takes a WideTable: pack the logical table once with "
                             "pack_wide_table (device_table does it past MAX_REFS)")
        if table.num_refs != num_refs:
            raise ValueError(f"a WideTable of {table.num_refs} references probed for "
                             f"{num_refs}")
        nb, S, Wm = table.num_buckets, table.num_slots, table.mask_words
        if table.device != rows.device or not (table.slots.is_contiguous()
                                               and table.rows.is_contiguous()):
            raise ValueError("K11 takes a contiguous WideTable on the rows' device")
        # 16-byte loads of slot records and of four mask words
        P = table.rows.shape[1]
        if P < Wm or P % 4 or table.slots.data_ptr() % 16 or table.rows.data_ptr() % 16:
            raise ValueError(f"K11 takes 16-byte aligned slot records and mask rows of a "
                             f"multiple of 4 words >= {Wm}, got rows of {P} words")
    else:
        if isinstance(table, WideTable):
            raise ValueError("K2 takes the logical table, not a WideTable")
        if table.dtype != torch.int32 or table.dim() != 2 or table.device != rows.device:
            raise ValueError("panel probe takes an int32 [NB, width] table on the rows' device")
        nb = table.shape[0]
        S = table_slots(table.shape[1], num_refs)
        Wm = table.shape[1] // S - 3
    if nb & (nb - 1):
        raise ValueError(f"bucket count {nb} is not a power of two")
    B, n = rows.shape
    # per read: raw rows need >= n ranks-table slots of 8 bytes; past 256
    # references K2's counters go to shared memory too, and K11's hit list
    extra = n * 4 if wide else Wm * 128 if Wm > 8 else 0
    if (n * 8 if lens is None else 0) + extra > _SMEM_BYTES:
        raise ValueError(f"panel probe kernel: the shared memory of a row of {n} hashes "
                         f"at {num_refs} references does not fit")
    rows = rows.contiguous()
    if lens is not None:
        if lens.shape != (B,) or lens.device != rows.device:
            raise ValueError("lens must be [B] on the rows' device")
        lens = lens.to(torch.int32).contiguous()
    return rows, lens, nb.bit_length() - 1, S, Wm


def _panel_probe_cuda(rows, lens, table, num_refs, min_diff, min_matches, wide=None):
    """K2, or K11 where ``wide`` (default: num_refs > MAX_REFS)."""
    wide = num_refs > MAX_REFS if wide is None else wide
    rows, lens, log2nb, S, Wm = _cuda_args(rows, lens, table, num_refs, wide)
    B, n = rows.shape
    out = torch.empty((3, B), dtype=torch.int32, device=rows.device)
    if B and wide:
        kernels.PANEL_PROBE_WIDE(rows, lens, B, n, table.slots, table.rows, log2nb, S, Wm,
                                 table.rows.shape[1], num_refs, None, min_diff, min_matches, out,
                                 route="stream")
    elif B:
        kernels.PANEL_PROBE(rows, lens, B, n, table.contiguous(), log2nb, S, Wm, num_refs,
                            min_diff, min_matches, out)
    return out


def _panel_probe_filter_cuda(rows, lens, table, num_refs, ref_lens, min_diff, min_matches,
                             wide=None):
    """K2's filter epilogue, or K11's where ``wide`` (default: num_refs >
    MAX_REFS)."""
    wide = num_refs > MAX_REFS if wide is None else wide
    rows, lens, log2nb, S, Wm = _cuda_args(rows, lens, table, num_refs, wide)
    if ref_lens.shape != (num_refs,) or ref_lens.device != rows.device:
        raise ValueError("ref_lens must be [num_refs] on the rows' device")
    ref_lens = ref_lens.to(torch.int32).contiguous()
    B, n = rows.shape
    out = torch.empty((5, B), dtype=torch.int32, device=rows.device)
    if B and wide:
        kernels.PANEL_PROBE_WIDE(rows, lens, B, n, table.slots, table.rows, log2nb, S, Wm,
                                 table.rows.shape[1], num_refs, ref_lens, min_diff, min_matches,
                                 out, route="filter")
    elif B:
        kernels.PANEL_PROBE_FILTER(rows, lens, B, n, table.contiguous(), log2nb, S, Wm,
                                   num_refs, ref_lens, min_diff, min_matches, out)
    return out


def panel_probe(rows: torch.Tensor, lens: torch.Tensor | None, table, num_refs: int,
                min_diff: int, min_matches: int) -> torch.Tensor:
    """[B, n] int64 rows -> int32 [3, B] (best, shared, flags).  ``table``
    is the logical table or, past MAX_REFS on a GPU as K11 needs it, its
    ``WideTable``."""
    if rows.device.type == "cuda":
        return _panel_probe_cuda(rows, lens, table, num_refs, min_diff, min_matches)
    if rows.device.type != "cpu":
        raise ValueError(f"no panel-probe path for device {rows.device}")
    if isinstance(table, WideTable):
        return panel_probe_wide_packed_plain(rows, lens, table, num_refs, min_diff, min_matches)
    return panel_probe_plain(rows, lens, table, num_refs, min_diff, min_matches)


def panel_probe_filter(rows: torch.Tensor, lens: torch.Tensor | None, table, num_refs: int,
                       ref_lens: torch.Tensor, min_diff: int, min_matches: int) -> torch.Tensor:
    """[B, n] int64 rows + the references' sketch lengths [R] -> int32
    [5, B] (best, shared, total_union, keep, flags)."""
    if rows.device.type == "cuda":
        return _panel_probe_filter_cuda(rows, lens, table, num_refs, ref_lens, min_diff,
                                        min_matches)
    if rows.device.type != "cpu":
        raise ValueError(f"no panel-probe path for device {rows.device}")
    if isinstance(table, WideTable):
        return panel_probe_wide_packed_plain(rows, lens, table, num_refs, min_diff, min_matches,
                                             ref_lens)
    return panel_probe_filter_plain(rows, lens, table, num_refs, ref_lens, min_diff,
                                    min_matches)
