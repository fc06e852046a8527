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
they hit, and how many reference bits each hit's mask holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rkmh_tpu_torch.ops.intersect import occ_ranks, prefix_eq_ranks
from rkmh_tpu_torch.ops.lookup import M32, bucket_indices, table_slots
from rkmh_tpu_torch.ops.sketch import SENTINEL

HBM_BYTES_PER_S = 3.35e12
SECTOR = 32
_CHUNK = 1 << 20  # probes gathered per step


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
    for c0 in range(0, h.numel(), _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        g = table[bucket[sl]].to(torch.int64) & M32  # [c, width]
        match = (g[:, S : 2 * S] == lo[sl, None]) & (g[:, 2 * S : 3 * S] == o[sl, None])
        slot = match.to(torch.int8).argmax(dim=-1)  # the first matching slot
        ok = match.any(dim=-1) & (g[:, :S].gather(1, slot[:, None])[:, 0] == hi[sl])
        hits += int(ok.sum())
        for w in range(Wm):
            m = g[:, (3 + w) * S : (4 + w) * S].gather(1, slot[:, None])[ok, 0]
            bits += sum(int(((m >> r) & 1).sum()) for r in range(32))
        hit_keys.append(bucket[sl][ok] * S + slot[ok])
    buckets = torch.unique(bucket)
    lanes = torch.arange(S, 3 * S, device=rows.device)
    addr = [((buckets[:, None] * width + lanes) * 4).reshape(-1)]
    if hit_keys:
        keys = torch.unique(torch.cat(hit_keys))
        hit_lanes = torch.tensor([0] + [3 + w for w in range(Wm)], device=rows.device) * S
        addr.append((((keys // S)[:, None] * width + hit_lanes + (keys % S)[:, None]) * 4)
                    .reshape(-1))
    return ProbeStats(int(h.numel()), hits, bits, sector_bytes(torch.cat(addr)))


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


def read_row_bytes(rows: torch.Tensor, lens: torch.Tensor | None) -> int:
    """Row bytes a probe needs: every element of raw rows, the first
    min(len, n) of sorted ones."""
    if lens is None:
        return tensor_bytes(rows)
    return int(lens.clamp(max=rows.shape[-1]).sum()) * rows.element_size()
