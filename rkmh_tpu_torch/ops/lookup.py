"""Panel lookup table: the (hash, occ) -> reference-bitmask bucket table.

(a) The host builder is a numpy copy of ``rkmh_tpu/ops/lookup.py:77-293``
and :393-415 (``predicted_buckets``, ``pick_slots`` with both slot
policies, ``projected_table_bytes``, ``table_slots``,
``_collect_entries``, ``_bucket_of``, ``build_panel_table``,
``PanelTable``, ``build_set_table``), copied for the reason given in
``io/fastx.py``.  It builds the identical table from the same sketches or
hash sets, with the same defaults and overrides, read at import with
rkmh-tpu's error texts (:58-75): ``RKMH_TPU_SLOTS`` forces the slot width
of every build, ``RKMH_TPU_TABLE_BUDGET_MB`` (64) is the size budget that
picks it.  It takes the forced geometry (``num_buckets``, ``slots``) that
gives every tp shard of a sharded panel one shape
(``parallel/mesh.build_sharded_tables``).

(b) The query, plain PyTorch (``lookup.py:296-390``): ``bucket_indices``,
``counts_from_rows``, ``lookup_intersection_counts(_masked)``.  Table
lanes are uint32 bit patterns in int32 and are widened to int64 before
any compare or max, because an int32 lane >= 2**31 is negative.

(c) The sorted-key panel, hpv16's fallback past the set-table cap
(``lookup.py:634-691``): ``build_sorted_panel`` (numpy, identical arrays)
and its plain query ``sorted_panel_counts(_masked)``.  The query takes the
keys as int64 with the sign bit flipped (``h ^ INT64_MIN``,
``flip_keys``), so that torch's signed ``searchsorted`` sees the
reference's unsigned order, and the masks as int32 [U, Wm].

(d) The device builds (``lookup.py:430-611``): ``count_unique_keys_device``,
``device_set_table``, ``build_set_table_device``,
``build_sharded_set_tables_device`` and ``build_panel_table_device`` build
on the device of their input tensors the tables of rkmh-tpu's device
builds, bit for bit.  (Those order a bucket's slots by (lo, occ), the host
build by hash: the two builds agree query for query, not bit for bit.)
The steps before the fill are library calls: stable ``torch.sort``s in
place of the multi-key sorts, ``cumsum``, ``index_put_``.  The fill (run
starts, ranks in a bucket, the (lo, occ) collision test, ``max_rank`` and
every lane of the table) is the set-table fill kernel K13
(``csrc/set_table.cu``) on a CUDA tensor and ``set_table_fill_plain``, the
JAX chain in torch ops, on a CPU tensor.

Table layout: [NB, S*(3+Wm)] lanes per bucket row, slot-major
``[hi*S | lo*S | occ*S | mask_w*S ...]``; bit r of an entry's mask is set
iff reference r's sketch holds at least occ+1 copies of the hash.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.intersect import occ_ranks
from rkmh_tpu_torch.ops.popcount import vertical_popcounts
from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL

_SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
# RKMH_TPU_SLOTS forces a slot width everywhere; SLOTS is also the width of
# a device build's fill when none is given
_FORCED_SLOTS = os.environ.get("RKMH_TPU_SLOTS")
if _FORCED_SLOTS is not None:
    try:
        _forced_val = int(_FORCED_SLOTS)
    except ValueError:
        raise ValueError(
            f"RKMH_TPU_SLOTS={_FORCED_SLOTS!r}: must be a positive integer "
            "slot count (e.g. 2, 4, 8); unset it to auto-pick per panel"
        ) from None
    if _forced_val < 1:
        raise ValueError(
            f"RKMH_TPU_SLOTS={_FORCED_SLOTS!r}: must be >= 1; unset it to "
            "auto-pick per panel"
        )
    SLOTS = _forced_val
else:
    SLOTS = 4
_BUDGET_MB = int(os.environ.get("RKMH_TPU_TABLE_BUDGET_MB", "64"))
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


def _table_bytes(n_entries: int, mask_words: int, slots: int) -> int:
    return 4 * slots * (3 + mask_words) * predicted_buckets(n_entries, slots)


def pick_slots(n_entries: int, mask_words: int, policy: str = "narrow") -> int:
    """Slot width for a new table.

    ``narrow`` (classify panels): the smallest S in {2, 4} whose predicted
    table fits the size budget, else 8.  ``compact`` (set tables): the S in
    {2, 3, 4} with the fewest predicted table bytes if that fits the
    budget, else the fewer bytes of S = 8 and S = 12 (the hundreds-of-MB
    hpv16 panels; the choice of candidates is the JAX package's).  Under
    RKMH_TPU_SLOTS, that width."""
    if _FORCED_SLOTS:
        return SLOTS
    budget = _BUDGET_MB * (1 << 20)
    if policy == "compact":
        best = min((2, 3, 4), key=lambda s: _table_bytes(n_entries, mask_words, s))
        if _table_bytes(n_entries, mask_words, best) <= budget:
            return best
        return min((8, 12), key=lambda s: _table_bytes(n_entries, mask_words, s))
    if policy != "narrow":
        raise ValueError(f"unknown slot policy {policy!r}")
    for s in (2, 4):
        if _table_bytes(n_entries, mask_words, s) <= budget:
            return s
    return 8


def projected_table_bytes(n_entries: int, num_refs: int, policy: str = "compact") -> int:
    """Predicted bytes of the table build_panel_table makes for n entries over
    num_refs references (the auto-picked slots and bucket count)."""
    wm = max(1, (num_refs + 31) // 32)
    return _table_bytes(max(n_entries, 1), wm, pick_slots(n_entries, wm, policy))


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


def build_panel_table(ref_sk, ref_lens=None, num_refs: int | None = None,
                      policy: str = "narrow", num_buckets: int | None = None,
                      slots: int | None = None) -> PanelTable:
    """Build the bucket table from a sorted sketch matrix [R, t] (uint64,
    or int64 bit patterns; SENTINEL-padded rows, as bottom_s_sketch makes
    them).  ``num_buckets`` and ``slots`` force the geometry (the bucket
    count still doubles where a bucket overflows)."""
    ref_sk = np.asarray(ref_sk)
    if ref_sk.dtype == np.int64:
        ref_sk = ref_sk.view(np.uint64)
    ref_sk = ref_sk.astype(np.uint64, copy=False)
    R = ref_sk.shape[0] if num_refs is None else num_refs
    Wm = max(1, (R + 31) // 32)

    ents = _collect_entries(ref_sk, ref_lens, R, Wm)
    if ents is None:
        S = slots or pick_slots(0, Wm, policy)
        empty = np.zeros((num_buckets or 1, S * (3 + Wm)), dtype=np.uint32)
        empty[:, 2 * S : 3 * S] = _EMPTY_OCC
        return PanelTable(empty, R, Wm)
    h, occ, masks = ents
    n = len(h)
    S = slots or pick_slots(n, Wm, policy)
    lo = h.astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32)

    nb = num_buckets or predicted_buckets(n, S)
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


def _distinct_rows(ref_hash_rows) -> list[np.ndarray]:
    """Each row's distinct non-zero hashes, sorted, as uint64."""
    cleaned = []
    for row in ref_hash_rows:
        row = np.asarray(row)
        row = np.unique(row.view(np.uint64) if row.dtype == np.int64 else row.astype(np.uint64))
        cleaned.append(row[row != 0])
    return cleaned


def build_set_table(ref_hash_rows, num_refs: int | None = None) -> PanelTable:
    """Per-reference hash arrays (uint64 or int64 bit patterns, any order,
    duplicates and zeros allowed) -> a table of occ-0 entries only: the
    set semantics of the hpv16 comparators (rkmh.cpp:2673/2688).  A query
    element that repeats an earlier one carries occ > 0 and misses, so a
    full sorted read row counts distinct shared hashes."""
    cleaned = _distinct_rows(ref_hash_rows)
    maxlen = max([1, *map(len, cleaned)])
    mat = np.full((len(cleaned), maxlen), _SENTINEL_U64, dtype=np.uint64)
    lens = np.zeros(len(cleaned), dtype=np.int32)
    for i, row in enumerate(cleaned):
        mat[i, : len(row)] = row
        lens[i] = len(row)
    return build_panel_table(mat, lens, num_refs=len(cleaned) if num_refs is None else num_refs,
                             policy="compact")


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


# ---------------------------------------------------------------------------
# (c) the sorted-key panel (hpv16's fallback past the set-table cap)
# ---------------------------------------------------------------------------

def build_sorted_panel(ref_hash_rows: list, num_refs: int | None = None):
    """Per-reference hash arrays -> (sorted distinct keys [U] uint64,
    masks [U, Wm] uint32, bit r of a key's row set iff reference r holds
    it).  Zeros (invalid k-mers) are excluded; an empty panel gives one
    key 0 with an empty mask.  A copy of ``rkmh_tpu/ops/lookup.py:634``."""
    R = num_refs if num_refs is not None else len(ref_hash_rows)
    Wm = max(1, (R + 31) // 32)
    keys_all = []
    refs_all = []
    for r, row in enumerate(ref_hash_rows):
        row = np.asarray(row)
        row = np.unique(row.view(np.uint64) if row.dtype == np.int64 else row.astype(np.uint64))
        row = row[row != 0]
        keys_all.append(row)
        refs_all.append(np.full(len(row), r, dtype=np.int64))
    if not keys_all or sum(len(x) for x in keys_all) == 0:
        return np.zeros(1, dtype=np.uint64), np.zeros((1, Wm), dtype=np.uint32)
    keys_cat = np.concatenate(keys_all)
    refs_cat = np.concatenate(refs_all)
    uniq, inv = np.unique(keys_cat, return_inverse=True)
    masks = np.zeros((len(uniq), Wm), dtype=np.uint32)
    np.bitwise_or.at(
        masks, (inv, refs_cat // 32), (np.uint32(1) << (refs_cat % 32)).astype(np.uint32)
    )
    return uniq, masks


def flip_keys(keys_u64: np.ndarray) -> np.ndarray:
    """Sorted uint64 keys -> int64 with the sign bit flipped, sorted as
    signed values in the same order."""
    return np.asarray(keys_u64, dtype=np.uint64).view(np.int64) ^ np.int64(INT64_MIN)


def sorted_panel_counts_masked(read_sk: torch.Tensor, qmask: torch.Tensor,
                               keys_flipped: torch.Tensor, masks: torch.Tensor,
                               num_refs: int) -> torch.Tensor:
    """[B, s] int64 hashes + bool query mask (True = query this element)
    -> [B, R] int32 counts of the queried elements found, per reference.
    Callers enforce set semantics by masking later occurrences out."""
    q = read_sk ^ INT64_MIN
    pos = torch.searchsorted(keys_flipped, q.reshape(-1)).reshape(q.shape)
    pos = pos.clamp(0, keys_flipped.shape[0] - 1)
    hit = (keys_flipped[pos] == q) & qmask
    mw = torch.where(hit[..., None], masks[pos].to(torch.int64) & M32,
                     torch.zeros((), dtype=torch.int64, device=read_sk.device))  # [B, s, Wm]
    counts = [vertical_popcounts(mw[..., w], min(32, num_refs - 32 * w))
              for w in range((num_refs + 31) // 32)]
    return torch.cat(counts, dim=-1)


def sorted_panel_counts(read_sk: torch.Tensor, read_lens: torch.Tensor,
                        keys_flipped: torch.Tensor, masks: torch.Tensor,
                        num_refs: int) -> torch.Tensor:
    """[B, s] sorted read hash arrays -> [B, R] distinct shared counts:
    only the first occurrence of a value queries the panel."""
    s = read_sk.shape[-1]
    qmask = ((torch.arange(s, device=read_sk.device)[None, :] < read_lens[:, None])
             & (read_sk != SENTINEL) & (occ_ranks(read_sk) == 0))
    return sorted_panel_counts_masked(read_sk, qmask, keys_flipped, masks, num_refs)


# ---------------------------------------------------------------------------
# (d) device builds (rkmh_tpu/ops/lookup.py:430-611)
# ---------------------------------------------------------------------------

def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 of the same 32 bits."""
    return (((x + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def _sorted_elements(hashes: torch.Tensor, mask: torch.Tensor, occs=None):
    """[R, W] int64 hashes, validity mask and optional occurrence ranks ->
    the elements sorted by (unsigned hash, occ, row), as the three-key sort
    of ``rkmh_tpu/ops/lookup.py:443-452`` orders them: (hashes, occs, rows,
    key_first, valid), zeros and masked elements made SENTINEL (they sort
    last and are invalid).  torch has no multi-key sort: stable sorts from
    the least significant key, the row already ascending in row-major
    order."""
    W = hashes.shape[1]
    h = torch.where(mask & (hashes != 0), hashes, SENTINEL).reshape(-1)
    oc = torch.zeros_like(h) if occs is None else occs.reshape(-1).to(torch.int64)
    order = (torch.arange(h.numel(), device=h.device) if occs is None
             else torch.sort(oc, stable=True).indices)
    order = order[torch.sort(h[order] ^ INT64_MIN, stable=True).indices]
    hs, ocs = h[order], oc[order]
    key_first = torch.ones_like(hs, dtype=torch.bool)
    key_first[1:] = (hs[1:] != hs[:-1]) | (ocs[1:] != ocs[:-1])
    return hs, ocs, order // max(W, 1), key_first, hs != SENTINEL


def count_unique_keys_device(hashes: torch.Tensor, mask: torch.Tensor, occs=None) -> int:
    """Distinct valid (hash, occ) keys of [R, W] int64 hashes under a mask
    (``_count_unique_keys``, ``rkmh_tpu/ops/lookup.py:524-539``): the entry
    count that sizes a table."""
    *_, key_first, valid = _sorted_elements(hashes, mask, occs)
    return int((key_first & valid).sum())


def _unique_entries(hashes: torch.Tensor, mask: torch.Tensor, num_refs: int, occs=None):
    """The distinct valid (hash, occ) keys, in (unsigned hash, occ) order,
    and their reference masks (``rkmh_tpu/ops/lookup.py:437-476``): (keys
    [n] int64, occs [n] int64, masks [n, Wm] int32).  A bit is added once
    for each distinct (key, row) pair, so the sum of a word's bits is their
    or (bit 31 adds -2**31 and the int32 sum never wraps)."""
    hs, ocs, rows, key_first, valid = _sorted_elements(hashes, mask, occs)
    nv = int(valid.sum())  # the valid elements come first
    hs, ocs, rows, key_first = hs[:nv], ocs[:nv], rows[:nv], key_first[:nv]
    pair_first = key_first.clone()
    pair_first[1:] |= rows[1:] != rows[:-1]
    seg = torch.cumsum(key_first, 0) - 1
    r = rows[pair_first]
    masks = torch.zeros((int(key_first.sum()), max(1, (num_refs + 31) // 32)),
                        dtype=torch.int32, device=hs.device)
    masks.index_put_((seg[pair_first], r // 32), _int32_bits(torch.ones_like(r) << (r % 32)),
                     accumulate=True)
    return hs[key_first], ocs[key_first], masks


def set_table_fill_plain(bucket: torch.Tensor, lo: torch.Tensor, occ: torch.Tensor,
                         hi: torch.Tensor, idx: torch.Tensor, masks: torch.Tensor, nb: int,
                         slots: int):
    """The plain version of K13: the chain of ``rkmh_tpu/ops/lookup.py:489-516``
    in torch ops, on any device.  Entries [n] int32 sorted by (bucket, lo,
    occ) (bucket nb: left out), idx their rows of masks [*, Wm] int32 ->
    (table [nb, slots * (3 + Wm)] int32, max_rank [1] int32: the largest
    rank in a bucket, or ``slots`` on a (lo, occ) collision in a bucket)."""
    n, Wm, dev = bucket.numel(), masks.shape[1], bucket.device
    b = bucket.to(torch.int64)
    iota = torch.arange(n, device=dev)
    run_first = torch.ones(n, dtype=torch.bool, device=dev)
    run_first[1:] = b[1:] != b[:-1]
    rank = iota - torch.cummax(torch.where(run_first, iota, 0), 0).values
    valid = b < nb
    collide = ~run_first[1:] & (lo[1:] == lo[:-1]) & (occ[1:] == occ[:-1]) & valid[1:]
    none = torch.full((1,), -1, dtype=torch.int64, device=dev)
    max_rank = torch.maximum(torch.cat([none, torch.where(valid, rank, -1)]).amax(),
                             torch.where(collide.any(), slots, -1)).reshape(1)
    table = torch.zeros((nb, slots * (3 + Wm)), dtype=torch.int32, device=dev)
    table.view(nb, 3 + Wm, slots)[:, 2] = -1  # an empty slot's occ: 0xFFFFFFFF
    keep = valid & (rank < slots)
    kb, kr = b[keep], rank[keep]
    kept_masks = masks[idx[keep].long()]
    for j, lane in enumerate([hi[keep], lo[keep], occ[keep]]
                             + [kept_masks[:, w] for w in range(Wm)]):
        table[kb, j * slots + kr] = lane
    return table, max_rank.to(torch.int32)


def _set_table_fill_cuda(bucket, lo, occ, hi, idx, masks, nb: int, slots: int):
    """K13 wrapper."""
    n, Wm = bucket.numel(), masks.shape[-1]
    words = [bucket, lo, occ, hi, idx]
    if any(t.dtype != torch.int32 or t.dim() != 1 or t.numel() != n or t.device != bucket.device
           for t in words) or masks.dtype != torch.int32 or masks.dim() != 2 \
            or masks.device != bucket.device:
        raise ValueError("set-table fill kernel takes [n] int32 bucket, lo, occ, hi, idx and "
                         "[*, Wm] int32 masks on one device")
    if nb < 1 or slots < 1 or n > 2**31 - 2**17 or Wm >= 2**16 - 3:
        raise ValueError(f"set-table fill kernel: nb={nb}, slots={slots}, n={n}")
    table = torch.empty((nb, slots * (3 + Wm)), dtype=torch.int32, device=bucket.device)
    max_rank = torch.full((1,), -1, dtype=torch.int32, device=bucket.device)
    kernels.SET_TABLE_FILL(*(t.contiguous() for t in words), masks.contiguous(), n, nb, slots,
                           Wm, table, max_rank)
    return table, max_rank


def set_table_fill(bucket, lo, occ, hi, idx, masks, nb: int, slots: int):
    """K13 on a CUDA tensor, ``set_table_fill_plain`` on a CPU tensor."""
    if bucket.device.type == "cuda":
        return _set_table_fill_cuda(bucket, lo, occ, hi, idx, masks, nb, slots)
    if bucket.device.type != "cpu":
        raise ValueError(f"no set-table fill path for device {bucket.device}")
    return set_table_fill_plain(bucket, lo, occ, hi, idx, masks, nb, slots)


def fill_inputs(entries, nb: int, ranked: bool):
    """``_unique_entries``' output at nb buckets -> K13's inputs: the
    entries' (bucket, lo, occ, hi, entry index) as int32, sorted by (bucket,
    lo, occ), ties in entry order (``rkmh_tpu/ops/lookup.py:478-488``), and
    the masks.  ``ranked``: occs may be non-zero (a stable sort by occ
    first)."""
    keys, occs, masks = entries
    lo, hi = keys & M32, (keys >> 32) & M32
    b = bucket_indices(lo, hi, occs, nb)
    order = (torch.sort(occs, stable=True).indices if ranked
             else torch.arange(keys.numel(), device=keys.device))
    order = order[torch.sort(((b << 32) | lo)[order], stable=True).indices]
    return (b[order].to(torch.int32), _int32_bits(lo[order]), _int32_bits(occs[order]),
            _int32_bits(hi[order]), order.to(torch.int32), masks)


def device_set_table(hashes: torch.Tensor, mask: torch.Tensor, nb: int, num_refs: int,
                     occs=None, slots: int = SLOTS):
    """[R, W] int64 hashes + validity mask (+ occurrence ranks) -> (table
    [nb, slots * (3 + Wm)] int32, max_rank [1] int32), on their device
    (``_device_set_table``, ``rkmh_tpu/ops/lookup.py:430-521``).  With
    occs None every entry is occ 0 (a set table); max_rank >= slots means
    a bucket overflowed or held two entries of equal (lo, occ)."""
    entries = _unique_entries(hashes, mask, num_refs, occs)
    return set_table_fill(*fill_inputs(entries, nb, occs is not None), nb, slots)


def _grown(entries, nb: int, slots: int, ranked: bool) -> torch.Tensor:
    """The table at nb buckets, doubled until no bucket overflows or
    collides."""
    while True:
        table, max_rank = set_table_fill(*fill_inputs(entries, nb, ranked), nb, slots)
        if int(max_rank) < slots:
            return table
        del table
        nb *= 2


def build_set_table_device(hashes: torch.Tensor, mask: torch.Tensor, num_refs: int,
                           est_entries: int | None = None) -> torch.Tensor:
    """The set table of [R, W] int64 window hashes under a mask, on their
    device (``rkmh_tpu/ops/lookup.py:542-556``): the compact slot policy
    and the predicted bucket count for est_entries (default: the distinct
    keys), doubled while max_rank >= S."""
    entries = _unique_entries(hashes, mask, num_refs)
    n = est_entries or entries[0].numel()
    S = pick_slots(n, max(1, (num_refs + 31) // 32), policy="compact")
    return _grown(entries, predicted_buckets(n, S), S, False)


def build_sharded_set_tables_device(hashes: torch.Tensor, mask: torch.Tensor, tp: int):
    """[R, W] window hashes and mask -> ([tp, NB, width] int32 set tables,
    references per shard) on their device (``rkmh_tpu/ops/lookup.py:
    559-589``): shard j holds rows [j * rps, (j + 1) * rps), its mask bit r
    its local row r (R % tp == 0: callers pad with masked rows at the end).
    Every shard takes one geometry: S from the largest shard's distinct keys
    at Wm = ceil(rps / 32), the largest predicted bucket count, and on any
    overflow every shard again at twice the buckets."""
    R = hashes.shape[0]
    if R % tp:
        raise ValueError(f"{R} refs not divisible by tp {tp}")
    rps = R // tp
    groups = [_unique_entries(hashes[j * rps: (j + 1) * rps], mask[j * rps: (j + 1) * rps], rps)
              for j in range(tp)]
    ns = [keys.numel() for keys, _, _ in groups]
    S = pick_slots(max(max(ns), 1), max(1, (rps + 31) // 32), policy="compact")
    nb = max(predicted_buckets(n, S) for n in ns)
    while True:
        tables = []
        for entries in groups:
            table, max_rank = set_table_fill(*fill_inputs(entries, nb, False), nb, S)
            if int(max_rank) >= S:  # rare bucket overflow: regrow every shard
                tables = None
                break
            tables.append(table)
        if tables is not None:
            return torch.stack(tables), rps
        nb *= 2


def build_panel_table_device(ref_sk: torch.Tensor, ref_lens: torch.Tensor,
                             num_refs: int | None = None) -> torch.Tensor:
    """The (hash, occ) panel table of sorted sketch rows [R, s] int64 and
    their lengths, on their device (``rkmh_tpu/ops/lookup.py:592-611``):
    query-identical to ``build_panel_table``, with the narrow slot policy."""
    R, s = ref_sk.shape
    num_refs = R if num_refs is None else num_refs
    qmask = torch.arange(s, device=ref_sk.device)[None, :] < ref_lens[:, None]
    entries = _unique_entries(ref_sk, qmask, num_refs, occ_ranks(ref_sk))
    n = entries[0].numel()
    S = pick_slots(n, max(1, (num_refs + 31) // 32))
    return _grown(entries, predicted_buckets(n, S), S, True)
