"""The fused hpv16 set-table probe: sorted hash rows -> per-read
(best type, its count, unique-group counts).

One call runs, per read, the bucket probe of the combined type + group
set table, the distinct counts per reference, the split into T type
counts and U group counts, and the first-max argmax over the types.  On a
CUDA tensor it is the set-probe kernel (``csrc/set_probe.cu``, K3); on a
CPU tensor it is ``set_probe_plain``, the plain port of the JAX package's
``hpv16_comb_stage1`` ranks and bucket indices, row gather and
``hpv16_comb_finish`` (``rkmh_tpu/classify/engine.py:736-791``), which the
kernel must match exactly.

The kernel reads the table in a layout of its own, ``PackedSetTable``,
made once per run by ``pack_set_table`` from the logical table of
``ops/lookup.build_set_table`` (which stays what the plain version, the
CPU path and ``convert.py`` see): per bucket a key record with the S lo
words and a bitmap of the occupied slots, per slot a record with hi and
the Wm mask words.  ``set_probe_packed_plain`` probes that layout in
plain PyTorch, in segments as the kernel's blocks do.

Rows are [B, n] int64 hashes sorted in unsigned order (bottom_s_sketch
over every window, cut to the first n columns) with lens [B]: valid = i <
len and h != SENTINEL.  The table must be a set table (every entry occ 0,
``ops/lookup.build_set_table``): the kernel probes only the first element
of each run of equal hashes, which is exact only for such a table.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.intersect import occ_ranks
from rkmh_tpu_torch.ops.lookup import (
    M32,
    bucket_indices,
    counts_from_rows,
    next_pow2,
    table_slots,
)
from rkmh_tpu_torch.ops.popcount import vertical_popcounts
from rkmh_tpu_torch.ops.sketch import SENTINEL

# the plain version gathers [reads, n, width] rows; it goes through the
# batch in pieces of at most this many int32 lanes to bound its memory
_PLAIN_LANES = 1 << 28
_EMPTY_OCC = -1   # 0xFFFFFFFF in an int32 lane: an empty slot
SEGMENT = 2048    # elements of a read that one block of the kernel takes
MAX_SLOTS = 31    # the occupancy bitmap is one 32-bit word beside the lo words


@dataclass
class PackedSetTable:
    """A set table in the kernel's layout.  ``keys`` [NB, KW] int32: the S
    lo words of a bucket, zeros, and in the last word bit s set iff slot s
    holds an entry; KW = max(4, next power of two of S + 1).  ``slots``
    [NB * S, SW] int32: hi, then the Wm mask words, zero-padded to SW = 4 *
    ceil((1 + Wm) / 4).  Every record is a whole number of 16-byte vectors."""

    keys: torch.Tensor
    slots: torch.Tensor
    num_slots: int
    mask_words: int

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def nbytes(self) -> int:
        return 4 * (self.keys.numel() + self.slots.numel())


def pack_set_table(table: torch.Tensor, num_refs: int) -> PackedSetTable:
    """The logical set table [NB, S * (3 + Wm)] int32 (lanes ``[hi*S | lo*S
    | occ*S | mask_w*S ...]``, occ 0 in an entry and 0xFFFFFFFF in an empty
    slot) -> its packed layout on the same device, in plain torch ops.
    Made once per run, never per call."""
    nb, width = table.shape
    S = table_slots(width, num_refs)
    Wm = width // S - 3
    if S > MAX_SLOTS:
        raise ValueError(f"a packed set table holds at most {MAX_SLOTS} slots per bucket, got {S}")
    lanes = table.view(nb, 3 + Wm, S)
    occ = lanes[:, 2]
    if not bool(((occ == 0) | (occ == _EMPTY_OCC)).all()):
        raise ValueError("not a set table: an entry has occ > 0")
    KW = max(4, next_pow2(S + 1))
    keys = torch.zeros((nb, KW), dtype=torch.int32, device=table.device)
    keys[:, :S] = lanes[:, 1]
    bits = ((occ == 0).to(torch.int64) << torch.arange(S, device=table.device)).sum(dim=1)
    keys[:, KW - 1] = bits.to(torch.int32)  # S <= 31: the sum is below 2**31
    SW = 4 * -(-(1 + Wm) // 4)
    slots = torch.zeros((nb, S, SW), dtype=torch.int32, device=table.device)
    slots[:, :, 0] = lanes[:, 0]
    slots[:, :, 1 : 1 + Wm] = lanes[:, 3:].permute(0, 2, 1)
    return PackedSetTable(keys, slots.view(nb * S, SW), S, Wm)


def set_probe_plain(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor,
                    num_types: int, num_uniq: int) -> torch.Tensor:
    B, n = rows.shape
    step = max(1, _PLAIN_LANES // max(1, n * table.shape[1]))
    parts = []
    for r0 in range(0, B, step):
        full, ln = rows[r0 : r0 + step], lens[r0 : r0 + step]
        occ = occ_ranks(full)
        qmask = (torch.arange(n, device=rows.device)[None, :] < ln[:, None]) & (full != SENTINEL)
        lo, hi = full & M32, (full >> 32) & M32
        gathered = table[bucket_indices(lo, hi, occ, table.shape[0])]
        parts.append(counts_from_rows(gathered, lo, hi, occ, qmask, num_types + num_uniq))
    counts = torch.cat(parts) if parts else torch.zeros(
        (0, num_types + num_uniq), dtype=torch.int32, device=rows.device)
    return _best_type_and_groups(counts, num_types)


def _best_type_and_groups(counts: torch.Tensor, num_types: int) -> torch.Tensor:
    """[B, T+U] counts -> int64 [B, 2+U]: jnp.argmax over the types (the
    first maximal index, 0 when all are 0), their max, the group counts."""
    tc = counts[:, :num_types]
    return torch.cat([tc.argmax(dim=-1, keepdim=True).to(torch.int64),
                      tc.amax(dim=-1, keepdim=True).to(torch.int64),
                      counts[:, num_types:].to(torch.int64)], dim=1)


def packed_segment_counts(rows: torch.Tensor, lens: torch.Tensor, packed: PackedSetTable,
                          num_refs: int, first: int, end: int) -> torch.Tensor:
    """What one block of the kernel counts: the [B, R] int32 distinct
    shared counts of the elements [first, end) of every row, probed in the
    packed layout.  A run start is told from the element before it, which
    for ``first`` > 0 lies in the segment before."""
    B, n = rows.shape
    end = min(end, n)
    S, Wm = packed.num_slots, packed.mask_words
    if end <= first:
        return torch.zeros((B, num_refs), dtype=torch.int32, device=rows.device)
    h = rows[:, first:end]
    prev = rows[:, max(first - 1, 0) : end - 1]
    if first == 0:
        prev = torch.cat([~h[:, :1], prev], dim=1)  # element 0 starts a run
    idx = torch.arange(first, end, device=rows.device)
    probe = (idx[None, :] < lens[:, None]) & (h != SENTINEL) & (h != prev)
    lo, hi = h & M32, (h >> 32) & M32
    nb = packed.keys.shape[0]
    bucket = bucket_indices(lo, hi, torch.zeros_like(lo), nb)
    key = packed.keys[bucket].to(torch.int64) & M32            # [B, m, KW]
    occupied = (key[..., -1:] >> torch.arange(S, device=rows.device)) & 1
    match = (key[..., :S] == lo[..., None]) & (occupied == 1) & probe[..., None]
    slot = match.to(torch.int8).argmax(dim=-1)                 # the first matching slot
    rec = packed.slots[bucket * S + slot].to(torch.int64) & M32  # [B, m, SW]
    ok = match.any(dim=-1) & (rec[..., 0] == hi)
    zero = torch.zeros((), dtype=torch.int64, device=rows.device)
    counts = [vertical_popcounts(torch.where(ok, rec[..., 1 + w], zero),
                                 min(32, num_refs - 32 * w)) for w in range(Wm)]
    return torch.cat(counts, dim=-1)


def set_probe_packed_plain(rows: torch.Tensor, lens: torch.Tensor, packed: PackedSetTable,
                           num_types: int, num_uniq: int,
                           bounds: list[int] | None = None) -> torch.Tensor:
    """The kernel's function on the packed layout in plain PyTorch: the
    counts of the segments between ``bounds`` (default: every SEGMENT
    elements) added up, then the first-max argmax over the types."""
    B, n = rows.shape
    if bounds is None:
        bounds = list(range(0, n, SEGMENT))
    bounds = [*bounds, n]
    counts = torch.zeros((B, num_types + num_uniq), dtype=torch.int32, device=rows.device)
    for first, end in zip(bounds[:-1], bounds[1:]):
        counts += packed_segment_counts(rows, lens, packed, num_types + num_uniq, first, end)
    return _best_type_and_groups(counts, num_types)


def _set_probe_cuda(rows, lens, packed, num_types, num_uniq, seg: int = SEGMENT):
    if rows.dtype != torch.int64 or rows.dim() != 2:
        raise ValueError(f"set probe takes [B, n] int64 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if not isinstance(packed, PackedSetTable):
        raise ValueError("on a CUDA device set probe takes a PackedSetTable: pack the "
                         "logical table once with pack_set_table")
    if packed.device != rows.device:
        raise ValueError("the packed set table lies on another device than the rows")
    if num_types < 1 or num_uniq < 0:
        raise ValueError(f"set probe needs >= 1 type and >= 0 groups, got "
                         f"{num_types} and {num_uniq}")
    S, Wm = packed.num_slots, packed.mask_words
    if num_types + num_uniq > 32 * Wm:
        raise ValueError(f"{num_types} + {num_uniq} references do not fit {Wm} mask words")
    nb = packed.keys.shape[0]
    if nb & (nb - 1):
        raise ValueError(f"bucket count {nb} is not a power of two")
    B, n = rows.shape
    if lens.shape != (B,) or lens.device != rows.device:
        raise ValueError("lens must be [B] on the rows' device")
    if n and rows.stride(1) != 1:
        rows = rows.contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty((B, 2 + num_uniq), dtype=torch.int64, device=rows.device)
    if B:
        counts = done = None
        if n > seg:  # some read may span several blocks
            scratch = torch.zeros(B * (32 * Wm + 1), dtype=torch.int32, device=rows.device)
            counts, done = scratch[B:], scratch[:B]
        kernels.SET_PROBE(rows, rows.stride(0), lens, B, n, packed.keys, packed.slots,
                          nb.bit_length() - 1, S, Wm, num_types, num_uniq, seg, counts, done,
                          out)
    return out


def set_probe(rows: torch.Tensor, lens: torch.Tensor, table, num_types: int,
              num_uniq: int) -> torch.Tensor:
    """[B, n] sorted int64 rows + lens -> int64 [B, 2+U].  ``table`` is the
    logical set table or, as the kernel needs it, its ``PackedSetTable``."""
    if rows.device.type == "cuda":
        return _set_probe_cuda(rows, lens, table, num_types, num_uniq)
    if rows.device.type != "cpu":
        raise ValueError(f"no set-probe path for device {rows.device}")
    if isinstance(table, PackedSetTable):
        return set_probe_packed_plain(rows, lens, table, num_types, num_uniq)
    return set_probe_plain(rows, lens, table, num_types, num_uniq)
