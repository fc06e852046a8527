"""Least times for the port's kernels, from the bytes each must move.

A kernel's bound is the bytes its function must move (each input read
once, each output written once) over the memory rate of an NVIDIA H100
SXM, 3.35 TB/s.  Where a kernel reaches into a table at random (the
panel and set probes, the counters), only the 32-byte sectors that this
call's data reaches are counted, taken from the data itself.  None of the
kernels runs on the tensor cores and the card's integer rates are not
among its published peaks, so every bound here is by bytes.

The probe statistics come from the plain pieces (``ops/lookup``), on the
tensors' device: which bucket rows the valid elements probe, which slots
they hit, and how many reference bits each hit's mask holds.  The exact
map of ``call`` (K8, K9), the sorted-key panel (K10) and the wide panel
probe (K11) are counted by their function, not by one layout's sectors:
the queries in, the outputs, and for each distinct key or entry that the
queries find its key and its value: 12 bytes (a key and its count) in the
map (``map_found_keys``; K9's queries are its mutated k-mers, hashed by
the plain pieces, ``call_engine.mutation_hashes``), 8 + 4 Wm (a key and
its mask row) in the sorted panel (``sorted_probe_work``), 12 + 4 Wm (a
hash, its occ and its mask row) in the wide table (``wide_probe_work``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rkmh_tpu_torch.ops.hashmap import SortedMap, sorted_keys
from rkmh_tpu_torch.ops.intersect import occ_ranks, prefix_eq_ranks
from rkmh_tpu_torch.ops.lookup import M32, bucket_indices, table_slots
from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL

HBM_BYTES_PER_S = 3.35e12
SECTOR = 32
_LANES = 1 << 25  # table lanes gathered per step (probes x row width)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sector_bytes(byte_addresses: torch.Tensor) -> int:
    """Bytes of the distinct 32-byte sectors that the addresses fall in."""
    return int(torch.unique(byte_addresses // SECTOR).numel()) * SECTOR


@dataclass
class ProbeStats:
    probes: int            # valid elements that probed a bucket row
    hits: int              # of them, those whose (hash, occ) is in the table
    mask_bits: int         # set bits over the hits' mask words
    table_bytes: int       # the sectors of the table the probes reach
    buckets: int = 0       # distinct bucket rows probed
    hit_slots: int = 0     # distinct (bucket, slot) entries hit


def probe_stats(rows: torch.Tensor, valid: torch.Tensor, occ: torch.Tensor,
                table: torch.Tensor, num_refs: int) -> ProbeStats:
    """What a probe of ``table`` [NB, S*(3+Wm)] int32 by the valid (hash,
    occ) pairs reads: the S lo and S occ lanes of each probed bucket row,
    then hi and the Wm mask lanes of the slot it hits."""
    nb, width = table.shape
    S = table_slots(width, num_refs)
    Wm = width // S - 3
    h, o = rows[valid], occ[valid].to(torch.int64)
    lo, hi = h & M32, (h >> 32) & M32
    bucket = bucket_indices(lo, hi, o, nb)
    hit_keys, hits, bits = [], 0, 0
    step = max(1, _LANES // width)
    for c0 in range(0, h.numel(), step):
        sl = slice(c0, c0 + step)
        g = table[bucket[sl]].to(torch.int64) & M32  # [c, width]
        match = (g[:, S : 2 * S] == lo[sl, None]) & (g[:, 2 * S : 3 * S] == o[sl, None])
        slot = match.to(torch.int8).argmax(dim=-1)  # the first matching slot
        ok = match.any(dim=-1) & (g[:, :S].gather(1, slot[:, None])[:, 0] == hi[sl])
        hits += int(ok.sum())
        words = (3 + torch.arange(Wm, device=rows.device)) * S
        m = g.gather(1, words[None, :] + slot[:, None])[ok]  # [hits, Wm] mask words
        bits += sum(int(((m >> r) & 1).sum()) for r in range(32))
        hit_keys.append(bucket[sl][ok] * S + slot[ok])
    buckets = torch.unique(bucket)
    lanes = torch.arange(S, 3 * S, device=rows.device)
    addr = [((buckets[:, None] * width + lanes) * 4).reshape(-1)]
    keys = buckets[:0]
    if hit_keys:
        keys = torch.unique(torch.cat(hit_keys))
        hit_lanes = torch.tensor([0] + [3 + w for w in range(Wm)], device=rows.device) * S
        addr.append((((keys // S)[:, None] * width + hit_lanes + (keys % S)[:, None]) * 4)
                    .reshape(-1))
    return ProbeStats(int(h.numel()), hits, bits, sector_bytes(torch.cat(addr)),
                      int(buckets.numel()), int(keys.numel()))


def panel_probe_stats(rows: torch.Tensor, lens: torch.Tensor | None, table: torch.Tensor,
                      num_refs: int) -> ProbeStats:
    """K2's probe of [B, n] rows in either row mode (``ops/probe.py``)."""
    if lens is None:
        return probe_stats(rows, rows != 0, prefix_eq_ranks(rows), table, num_refs)
    n = rows.shape[-1]
    valid = (torch.arange(n, device=rows.device)[None, :] < lens[:, None]) & (rows != SENTINEL)
    return probe_stats(rows, valid, occ_ranks(rows), table, num_refs)


def set_probe_stats(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor,
                    num_refs: int) -> ProbeStats:
    """K3's probe of sorted [B, n] rows: the valid run starts only, at occ
    0 (``csrc/set_probe.cu``)."""
    n = rows.shape[-1]
    occ = occ_ranks(rows)
    valid = ((torch.arange(n, device=rows.device)[None, :] < lens[:, None])
             & (rows != SENTINEL) & (occ == 0))
    return probe_stats(rows, valid, occ, table, num_refs)


@dataclass
class ProbeWork:
    nbytes: int   # what the function must move
    probes: int   # queried elements
    hits: int     # of them, those found
    found: int    # distinct keys (K10) or (hash, occ) entries (K11) found


SORTED_KEY = 8  # a sorted panel's key, beside its 4 * Wm mask bytes
WIDE_ENTRY = 12  # a panel entry's hash and occ, beside its 4 * Wm mask bytes


def sorted_probe_work(rows: torch.Tensor, lens: torch.Tensor, keys: torch.Tensor,
                      masks: torch.Tensor, num_uniq: int) -> ProbeWork:
    """K10 by its function, whatever the panel's layout: the rows (the
    first min(len, n) of each) and lens in, the int64 [B, 2 + U] output,
    and a key and its mask row for each distinct key that the valid run
    starts find in ``keys`` (flipped int64 [U]; ``masks`` [U, Wm])."""
    n = rows.shape[-1]
    valid = ((torch.arange(n, device=rows.device)[None, :] < lens[:, None])
             & (rows != SENTINEL) & (occ_ranks(rows) == 0))
    q = rows[valid] ^ INT64_MIN
    pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    hit = keys[pos] == q
    found = int(torch.unique(pos[hit]).numel())
    nbytes = (read_row_bytes(rows, lens) + tensor_bytes(lens) + rows.shape[0] * (2 + num_uniq) * 8
              + found * (SORTED_KEY + 4 * masks.shape[1]))
    return ProbeWork(nbytes, int(q.numel()), int(hit.sum()), found)


def wide_probe_work(rows: torch.Tensor, lens: torch.Tensor | None, wide,
                    ref_lens: torch.Tensor | None = None) -> ProbeWork:
    """K11 by its function, whatever the table's layout: the rows and lens
    in (``ref_lens`` too in filter mode), the int32 [3, B] output ([5, B]
    with ``ref_lens``), and an entry's hash, occ and mask row for each
    distinct (hash, occ) entry that the valid elements hit
    (``wide``: an ``ops/probe.WideTable``)."""
    from rkmh_tpu_torch.ops.probe import _valid_and_ranks, wide_hits

    valid, occ, _ = _valid_and_ranks(rows, lens)
    e = wide_hits(rows, valid, occ, wide)
    found = int(torch.unique(e[e >= 0]).numel())
    nbytes = (read_row_bytes(rows, lens) + tensor_bytes(lens, ref_lens)
              + (3 if ref_lens is None else 5) * 4 * rows.shape[0]
              + found * (WIDE_ENTRY + 4 * wide.mask_words))
    return ProbeWork(nbytes, int(valid.sum()), int((e >= 0).sum()), found)


def packed_set_table_bytes(st: ProbeStats, packed) -> int:
    """The bytes the same probes reach in K3's packed layout
    (``ops/set_probe.PackedSetTable``): one key record per probed bucket,
    one slot record per entry hit, each in whole sectors."""
    def sectors(words: int) -> int:
        return -(-4 * words // SECTOR) * SECTOR

    return (st.buckets * sectors(packed.keys.shape[1])
            + st.hit_slots * sectors(packed.slots.shape[1]))


def read_row_bytes(rows: torch.Tensor, lens: torch.Tensor | None) -> int:
    """Row bytes a probe needs: every element of raw rows, the first
    min(len, n) of sorted ones."""
    if lens is None:
        return tensor_bytes(rows)
    return int(lens.clamp(max=rows.shape[-1]).sum()) * rows.element_size()


MAP_ENTRY = 12  # a key and its count


def map_found_keys(flipped: torch.Tensor, hashes: torch.Tensor) -> torch.Tensor:
    """The distinct keys among ``hashes`` that the map holds (``flipped``:
    its sorted sign-flipped keys, ``ops/hashmap.sorted_keys``), flipped."""
    q = torch.unique(hashes.reshape(-1) ^ -(2**63))
    if flipped.numel() == 0:
        return q[:0]
    i = torch.searchsorted(flipped, q).clamp(max=flipped.numel() - 1)
    return q[flipped[i] == q]


def hashmap_get_bytes(sm: SortedMap, hashes: torch.Tensor) -> int:
    """K8: the keys in, the values out, an entry for each key found."""
    flipped, _ = sorted_keys(sm)
    return 12 * hashes.numel() + MAP_ENTRY * int(map_found_keys(flipped, hashes).numel())


def call_scan_bytes(ref_codes: torch.Tensor, sm: SortedMap, k: int,
                    chunk: int = 16384) -> int:
    """K9 on one reference row: the codes (and the pad code) and depth,
    avg and site in; snp_depth, snp_call, max_rescue, del_depth and
    del_call out; an entry for each distinct key that its 4k mutated
    k-mers a position find (hashed chunk by chunk of positions)."""
    from rkmh_tpu_torch.call_engine import mutation_hashes

    flipped, _ = sorted_keys(sm)
    P = ref_codes.shape[0] - k + 1
    found = []
    for j0 in range(0, P, chunk):
        _, snp, dels = mutation_hashes(ref_codes, k, j0, min(j0 + chunk, P))
        found.append(map_found_keys(flipped, torch.cat([snp.reshape(-1), dels.reshape(-1)])))
    keys = int(torch.unique(torch.cat(found)).numel()) if found else 0
    return (ref_codes.numel() + 1 + 9 * P + 4 * P * k * 5 + 4 * P
            + MAP_ENTRY * keys)


def sparse_margin_bytes(idx: torch.Tensor, val: torch.Tensor, num_classes: int) -> int:
    """The bytes K12 must move one way (``ops/sparse_margin``): idx and val
    read once, the [C, N] margins written (forward) or their gradient read
    (backward), and C float32 weights (or gradient entries) for each
    distinct index of an entry whose value is not 0."""
    distinct = int(torch.unique(idx[val != 0]).numel())
    return tensor_bytes(idx, val) + 4 * num_classes * (idx.shape[0] + distinct)
