"""Panel lookup table: the (hash, occ) -> reference-bitmask bucket table.

(a) The host builder is a numpy copy of ``rkmh_tpu/ops/lookup.py:77-293``
(``predicted_buckets``, ``pick_slots``, ``table_slots``,
``_collect_entries``, ``_bucket_of``, ``build_panel_table``,
``PanelTable``), copied for the reason given in ``io/fastx.py``.  It
builds the identical table from the same sketches, with the same defaults
(64 MB budget).  Not copied: the ``RKMH_TPU_SLOTS`` /
``RKMH_TPU_TABLE_BUDGET_MB`` overrides, the forced geometry of
tensor-parallel shards, the ``compact`` slot policy and the device-side
builders, which serve the hpv16 set tables.

(b) The query, plain PyTorch (``lookup.py:296-390``): ``bucket_indices``,
``counts_from_rows``, ``lookup_intersection_counts(_masked)``.  Table
lanes are uint32 bit patterns in int32 and are widened to int64 before
any compare or max, because an int32 lane >= 2**31 is negative.

Table layout: [NB, S*(3+Wm)] lanes per bucket row, slot-major
``[hi*S | lo*S | occ*S | mask_w*S ...]``; bit r of an entry's mask is set
iff reference r's sketch holds at least occ+1 copies of the hash.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from rkmh_tpu_torch.ops.intersect import occ_ranks
from rkmh_tpu_torch.ops.popcount import vertical_popcounts
from rkmh_tpu_torch.ops.sketch import SENTINEL

_SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_BUDGET_MB = 64
_EMPTY_OCC = np.uint32(0xFFFFFFFF)
_MIX = 0x85EBCA77
_MUL = 0x9E3779B1
M32 = 0xFFFFFFFF


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


# ---------------------------------------------------------------------------
# (a) host builder (numpy)
# ---------------------------------------------------------------------------

def predicted_buckets(n_entries: int, slots: int) -> int:
    """Bucket count at which a random drop of n entries overflows nowhere
    (expected overflowing buckets < 0.5, Poisson occupancy model)."""
    n = max(n_entries, 1)
    nb = max(2, next_pow2((4 * n + slots - 1) // slots))
    while True:
        lam = n / nb
        tail = 1.0 - math.exp(-lam) * sum(
            lam**i / math.factorial(i) for i in range(slots + 1)
        )
        if nb * tail < 0.5 or nb >= 1 << 30:
            return nb
        nb *= 2


def pick_slots(n_entries: int, mask_words: int) -> int:
    """Smallest slot width S in {2, 4} whose predicted table fits the size
    budget, else 8 (the classify panels' "narrow" policy)."""
    budget = _BUDGET_MB * (1 << 20)
    for s in (2, 4):
        if 4 * s * (3 + mask_words) * predicted_buckets(n_entries, s) <= budget:
            return s
    return 8


def table_slots(width: int, num_refs: int) -> int:
    """Slot width of a table row, derived from its lane count
    width = S * (3 + Wm), Wm = ceil(num_refs / 32)."""
    wm = max(1, (num_refs + 31) // 32)
    s, rem = divmod(width, 3 + wm)
    if rem or s < 1:
        raise ValueError(
            f"table width {width} is not S*(3+{wm}) for num_refs={num_refs}")
    return s


@dataclass
class PanelTable:
    """Host-built (hash, occ) -> ref-bitmask bucket table.

    table: [NB, S*(3+Wm)] uint32, slot-major lanes (see module doc)."""

    table: np.ndarray
    num_refs: int
    mask_words: int


def _collect_entries(ref_sk: np.ndarray, ref_lens, R: int, Wm: int):
    """(hash, occ) -> bitmask entries as parallel numpy arrays."""
    hs, occs, rids = [], [], []
    for r in range(ref_sk.shape[0]):
        row = ref_sk[r]
        if ref_lens is not None:
            row = row[: int(np.asarray(ref_lens)[r])]
        row = row[row != _SENTINEL_U64]
        if row.size == 0:
            continue
        occ = np.arange(row.size) - np.searchsorted(row, row, side="left")
        hs.append(row)
        occs.append(occ)
        rids.append(np.full(row.size, r, dtype=np.int64))
    if not hs:
        return None
    h = np.concatenate(hs).astype(np.uint64)
    o = np.concatenate(occs).astype(np.uint32)
    rid = np.concatenate(rids)

    # unique (hash, occ) pairs; build masks by OR-ing ref bits
    pair = np.stack([h, o.astype(np.uint64)], axis=1)
    uniq, inv = np.unique(pair, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    masks = np.zeros((len(uniq), Wm), dtype=np.uint32)
    np.bitwise_or.at(
        masks, (inv, rid // 32), (np.uint32(1) << (rid % 32).astype(np.uint32))
    )
    return uniq[:, 0], uniq[:, 1].astype(np.uint32), masks


def _bucket_of(lo: np.ndarray, hi: np.ndarray, occ: np.ndarray, nb: int):
    """Mult-shift mix of both halves + occ; must match bucket_indices."""
    x = (lo ^ (hi * np.uint32(_MIX)) ^ (occ * np.uint32(_MIX))) * np.uint32(_MUL)
    return (x >> np.uint32(32 - int(np.log2(nb)))).astype(np.int64)


def build_panel_table(ref_sk, ref_lens=None, num_refs: int | None = None) -> PanelTable:
    """Build the bucket table from a sorted sketch matrix [R, t] (uint64,
    or int64 bit patterns; SENTINEL-padded rows, as bottom_s_sketch makes
    them)."""
    ref_sk = np.asarray(ref_sk)
    if ref_sk.dtype == np.int64:
        ref_sk = ref_sk.view(np.uint64)
    ref_sk = ref_sk.astype(np.uint64, copy=False)
    R = ref_sk.shape[0] if num_refs is None else num_refs
    Wm = max(1, (R + 31) // 32)

    ents = _collect_entries(ref_sk, ref_lens, R, Wm)
    if ents is None:
        S = pick_slots(0, Wm)
        empty = np.zeros((1, S * (3 + Wm)), dtype=np.uint32)
        empty[:, 2 * S : 3 * S] = _EMPTY_OCC
        return PanelTable(empty, R, Wm)
    h, occ, masks = ents
    n = len(h)
    S = pick_slots(n, Wm)
    lo = h.astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32)

    nb = predicted_buckets(n, S)
    while True:
        b = _bucket_of(lo, hi, occ, nb)
        order = np.argsort(b, kind="stable")
        bs = b[order]
        # slot index within each bucket = rank within equal-b run
        starts = np.searchsorted(bs, bs, side="left")
        slot = np.arange(n) - starts
        if slot.max(initial=0) < S:
            # the query compares (lo, occ) per slot and verifies hi on the
            # selected entry, so no bucket may hold two equal (lo, occ)
            trip = np.stack([bs, lo[order].astype(np.int64), occ[order].astype(np.int64)], 1)
            if len(np.unique(trip, axis=0)) == n:
                break
        nb *= 2  # a bucket overflowed (or (lo, occ) collided): rebuild sparser

    width = S * (3 + Wm)
    table = np.zeros((nb, width), dtype=np.uint32)
    table[:, 2 * S : 3 * S] = _EMPTY_OCC
    table[bs, slot] = hi[order]
    table[bs, S + slot] = lo[order]
    table[bs, 2 * S + slot] = occ[order]
    for w in range(Wm):
        table[bs, (3 + w) * S + slot] = masks[order, w]
    return PanelTable(table, R, Wm)


# ---------------------------------------------------------------------------
# (b) query (plain PyTorch)
# ---------------------------------------------------------------------------

def bucket_indices(lo: torch.Tensor, hi: torch.Tensor, occ: torch.Tensor,
                   nb: int) -> torch.Tensor:
    """(lo, hi, occ) -> bucket, as _bucket_of computes it in uint32: each
    product is cut to 32 bits before the logical shift.  Inputs are int64
    holding values in [0, 2**32)."""
    shift = 32 - (int(nb).bit_length() - 1)
    x = lo ^ ((hi * _MIX) & M32) ^ ((occ * _MIX) & M32)
    return ((x * _MUL) & M32) >> shift


def counts_from_rows(rows: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     occ: torch.Tensor, qmask: torch.Tensor,
                     num_refs: int) -> torch.Tensor:
    """Slot compare + mask popcount over gathered bucket rows
    [B, s, width] int32 -> [B, R] int32 counts."""
    S = table_slots(rows.shape[-1], num_refs)
    Wm = rows.shape[-1] // S - 3

    def lanes(j):  # lane group j as uint32 values in int64
        return rows[..., j * S : (j + 1) * S].to(torch.int64) & M32

    # match on (lo, occ); the builder keeps (lo, occ) unique per bucket,
    # and hi is verified on the selected entry
    hit = (lanes(1) == lo[..., None]) & (lanes(2) == occ[..., None]) & qmask[..., None]
    zero = torch.zeros((), dtype=torch.int64, device=rows.device)
    ok = torch.where(hit, lanes(0), zero).amax(dim=-1) == hi
    counts = []
    for w in range(Wm):
        # at most one slot matches: max-select its mask word
        sel = torch.where(hit, lanes(3 + w), zero).amax(dim=-1)
        sel = torch.where(ok, sel, zero)
        counts.append(vertical_popcounts(sel, min(32, num_refs - 32 * w)))
    return torch.cat(counts, dim=-1)


def lookup_intersection_counts_masked(read_sk: torch.Tensor, qmask: torch.Tensor,
                                      occ: torch.Tensor, table: torch.Tensor,
                                      num_refs: int) -> torch.Tensor:
    """[B, s] int64 hashes (any order) + validity mask + occurrence ranks
    -> [B, R] int32 intersection counts via the bucket table."""
    lo = read_sk & M32
    hi = (read_sk >> 32) & M32
    occ = occ.to(torch.int64)
    rows = table[bucket_indices(lo, hi, occ, table.shape[0])]   # [B, s, width]
    return counts_from_rows(rows, lo, hi, occ, qmask, num_refs)


def lookup_intersection_counts(read_sk: torch.Tensor, read_lens: torch.Tensor,
                               table: torch.Tensor, num_refs: int) -> torch.Tensor:
    """[B, s] sorted read sketches -> [B, R] intersection counts."""
    s = read_sk.shape[-1]
    occ = occ_ranks(read_sk)
    qmask = (torch.arange(s, device=read_sk.device)[None, :] < read_lens[:, None]) & (
        read_sk != SENTINEL)
    return lookup_intersection_counts_masked(read_sk, qmask, occ, table, num_refs)
