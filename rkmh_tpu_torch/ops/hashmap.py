"""Exact uint64 -> int32 hash map: a cuckoo table built on the host,
queried in two probes.

Counterpart of ``rkmh_tpu/ops/hashmap.py``.  ``call`` needs rkmh's
``read_hash_to_depth`` map (rkmh.cpp:1570-1624): the exact depth of every
read k-mer hash, queried at every reference position and for ~4k mutated
k-mers a position.  ``HashMap``, ``build_hash_map`` (:48) and
``depth_map_from_hashes`` (:179) are numpy copies, so a map holds the same
bits in either package.

On the device the map is one int32 ``[T, 4]`` tensor of (hi, lo, value,
used) rows, so that a probe is one 16-byte load (``map_table``,
``convert.hashmap_from_numpy``).  ``hashmap_get`` is K8
(``csrc/hashmap.cu``) on a CUDA tensor and ``hashmap_get_plain`` on a CPU
tensor.  A missing key reads 0.  Key 0 is a real key (every invalid read
k-mer counts under hash 0): emptiness is the used flag alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rkmh_tpu_torch.ops import kernels

_MUL1 = 0x9E3779B1
_MUL2 = 0x85EBCA77
_M32 = 0xFFFFFFFF


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


@dataclass
class HashMap:
    hash_hi: np.ndarray  # [T] uint32
    hash_lo: np.ndarray  # [T] uint32
    used: np.ndarray     # [T] bool
    values: np.ndarray   # [T] int32


def build_hash_map(keys: np.ndarray, values: np.ndarray) -> HashMap:
    """keys: unique uint64; values: int32.  Host-side vectorised cuckoo:
    rounds of first-wins claims with eviction (a random side per key per
    round), then the classic sequential eviction walk for the last few
    stragglers; the table doubles only when that walk fails.  A copy of
    ``rkmh_tpu/ops/hashmap.py:48``, the same seed included, so the table
    bits are the JAX package's."""
    keys = np.asarray(keys, dtype=np.uint64)
    values = np.asarray(values, dtype=np.int32)
    assert keys.shape == values.shape
    n = len(keys)
    T = max(64, next_pow2(2 * max(n, 1)))

    lo_all = keys.astype(np.uint32)
    hi_all = (keys >> np.uint64(32)).astype(np.uint32)

    while True:
        mask_t = np.uint32(T - 1)
        used = np.zeros(T, dtype=bool)
        # which key occupies each slot (index into keys); -1 = empty
        slot_key = np.full(T, -1, dtype=np.int64)
        s1_all = (((lo_all ^ np.uint32(_MUL1)) * np.uint32(_MUL1)) & mask_t).astype(np.int64)
        s2_all = (((hi_all ^ np.uint32(_MUL2)) * np.uint32(_MUL2)) & mask_t).astype(np.int64)

        rng = np.random.default_rng(0xC0FFEE)
        pending = np.arange(n, dtype=np.int64)
        for _rnd in range(64):
            if pending.size == 0:
                break
            t1 = s1_all[pending]
            t2 = s2_all[pending]
            free1 = ~used[t1]
            free2 = ~used[t2]
            # a random eviction side per key: a global side locks small
            # key cycles into evicting each other forever
            side = rng.integers(0, 2, size=pending.size).astype(bool)
            evict = np.where(side, t2, t1)
            tgt = np.where(free1, t1, np.where(free2, t2, evict))
            # serialise within the round: the first pending key per slot wins
            order = np.argsort(tgt, kind="stable")
            ts = tgt[order]
            first = np.ones(ts.size, dtype=bool)
            first[1:] = ts[1:] != ts[:-1]
            win_pos = order[first]                  # positions in `pending`
            w_slots = tgt[win_pos]
            evicted = slot_key[w_slots]
            evicted = evicted[evicted >= 0]
            slot_key[w_slots] = pending[win_pos]
            used[w_slots] = True
            keep = np.ones(pending.size, dtype=bool)
            keep[win_pos] = False
            pending = np.concatenate([pending[keep], evicted])
        if 0 < pending.size <= 65536:
            # sequential eviction walk for the stragglers; an evicted key
            # never goes back into the slot it was just kicked out of
            ok = True
            for ki in pending.tolist():
                cur = ki
                came_from = -1
                placed = False
                for _step in range(10000):
                    c1, c2 = s1_all[cur], s2_all[cur]
                    if not used[c1]:
                        tgt = c1
                    elif not used[c2]:
                        tgt = c2
                    elif came_from == c1:
                        tgt = c2
                    elif came_from == c2:
                        tgt = c1
                    else:
                        tgt = c2 if rng.integers(2) else c1
                    prev = slot_key[tgt] if used[tgt] else -1
                    slot_key[tgt] = cur
                    used[tgt] = True
                    if prev < 0:
                        placed = True
                        break
                    came_from = tgt
                    cur = int(prev)
                if not placed:
                    ok = False
                    break
            if ok:
                pending = pending[:0]
        if pending.size == 0:
            occ = np.nonzero(used)[0]
            ki = slot_key[occ]
            hash_hi = np.zeros(T, dtype=np.uint32)
            hash_lo = np.zeros(T, dtype=np.uint32)
            vals = np.zeros(T, dtype=np.int32)
            hash_hi[occ] = hi_all[ki]
            hash_lo[occ] = lo_all[ki]
            vals[occ] = values[ki]
            return HashMap(hash_hi, hash_lo, used, vals)
        T *= 2


def depth_map_from_hashes(hashes: np.ndarray, mask: np.ndarray | None = None) -> HashMap:
    """hash -> count over the window hashes (the mask's, if given): the
    read depth map of rkmh.cpp:1616-1623.  Zeros count too: every invalid
    read k-mer adds to map[0], as the reference's operator[] loop does."""
    h = np.asarray(hashes)
    h = h.view(np.uint64) if h.dtype == np.int64 else h.astype(np.uint64, copy=False)
    if mask is not None:
        h = h[np.asarray(mask, dtype=bool)]
    keys, counts = np.unique(h, return_counts=True)
    return build_hash_map(keys, counts.astype(np.int32))


def map_table(hm: HashMap, device) -> torch.Tensor:
    """A HashMap -> its [T, 4] int32 (hi, lo, value, used) table on ``device``."""
    rows = np.stack([np.asarray(hm.hash_hi, np.uint32).view(np.int32),
                     np.asarray(hm.hash_lo, np.uint32).view(np.int32),
                     np.asarray(hm.values, np.int32),
                     np.asarray(hm.used, bool).astype(np.int32)], axis=1)
    return torch.from_numpy(rows).to(device)


def table_size(table: torch.Tensor) -> int:
    """T of a [T, 4] int32 map table; raises on any other layout."""
    T = table.shape[0] if table.dim() == 2 else 0
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != 4 \
            or T & (T - 1) or not 0 < T <= 1 << 32:
        raise ValueError(f"a hash map table is [T, 4] int32 with T a power of two, got "
                         f"{tuple(table.shape)} {table.dtype}")
    return T


def device_table_size(table: torch.Tensor) -> int:
    """table_size, for a table the kernels read a slot at a time as one
    16-byte load (K8, K9): contiguous and 16-byte aligned."""
    T = table_size(table)
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("the map kernels take a contiguous, 16-byte aligned table")
    return T


def slots(hashes: torch.Tensor, T: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A key's two slots (``rkmh_tpu/ops/hashmap.py:167-170``): the uint32
    products of its halves, taken in int64, whose low 32 bits wrap as
    uint32 arithmetic does; T a power of two."""
    lo = hashes & _M32
    hi = (hashes >> 32) & _M32  # >> is arithmetic on int64: mask
    return (((lo ^ _MUL1) * _MUL1) & (T - 1), ((hi ^ _MUL2) * _MUL2) & (T - 1))


def hashmap_get_plain(table: torch.Tensor, hashes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch lookup: [...] int64 keys -> [...] int32 values, 0 for
    a missing key."""
    T = table_size(table)
    h = hashes.to(torch.int64)
    lo, hi = h & _M32, (h >> 32) & _M32
    out = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    for s in slots(h, T):
        e = table[s].to(torch.int64)  # [..., 4]
        hit = (e[..., 3] != 0) & ((e[..., 0] & _M32) == hi) & ((e[..., 1] & _M32) == lo)
        out = torch.where(hit, e[..., 2].to(torch.int32), out)
    return out


def _hashmap_get_cuda(table: torch.Tensor, hashes: torch.Tensor) -> torch.Tensor:
    """K8 wrapper."""
    T = device_table_size(table)
    if hashes.dtype != torch.int64 or hashes.device != table.device:
        raise ValueError(f"hash-map kernel takes int64 keys on the table's device, got "
                         f"{hashes.dtype} on {hashes.device}")
    keys = hashes.contiguous()
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if keys.numel():
        kernels.HASHMAP_GET(keys, keys.numel(), table, T, out)
    return out


def hashmap_get(table: torch.Tensor, hashes: torch.Tensor) -> torch.Tensor:
    """The value of every key (0 where absent): K8 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if hashes.device.type == "cuda":
        return _hashmap_get_cuda(table, hashes)
    if hashes.device.type != "cpu":
        raise ValueError(f"no hash-map path for device {hashes.device}")
    return hashmap_get_plain(table, hashes)
