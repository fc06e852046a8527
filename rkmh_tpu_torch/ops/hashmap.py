"""Exact uint64 -> int32 map: the keys sorted under a directory of their
top bits, built straight from ``np.unique``.

Counterpart of ``rkmh_tpu/ops/hashmap.py``: the same function, not its
layout.  ``call`` needs rkmh's ``read_hash_to_depth`` map
(rkmh.cpp:1570-1624): the exact depth of every read k-mer hash, 0 for a
key it lacks, queried at every reference position and for ~4k mutated
k-mers a position.  Key 0 is a real key (every invalid read k-mer counts
under hash 0).  The JAX package places its keys in a cuckoo table of
next_pow2(2n) 16-byte slots, 134 MB for call's 2.1M keys: past the card's
L2, and its placement is most of the host's build.  ``np.unique`` already
returns the keys sorted with their counts, so this map takes them as they
come:

* ``bits`` B = max(MIN_BITS, bit_length(n) - 2), so that a bucket (the
  keys that share their top B bits) holds 2 to 4 keys on average;
* ``dir`` [2**B + 1] int32: bucket b's keys are entries [dir[b],
  dir[b+1]);
* ``words`` [n] int64: entry i is key i's low 64 - B bits (the top B are
  the bucket's) over a B-bit count, ``key << B | count``, so a bucket's
  words are sorted (unsigned) as its keys are;
* a count that does not fit (>= 2**B - 1, or negative) is stored as
  2**B - 1, and the key and its value go to ``ov_keys`` [m] int64 and
  ``ov_values`` [m] int32, sorted: at call's map that is key 0 alone,
  where invalid k-mers are many.

For the 2,106,405 keys of call's workload that is 21 MB (B = 20), inside
the ~24 MB that every SM can read at random at the L2's rate
(``bench/l2_sweep.py``; PERF.md).  A probe (``csrc/hashmap.cuh``) reads
dir[b] and dir[b+1], then scans the bucket's words to the first one that
is not below the key's.

The map is one int64 tensor with views (one host-to-device copy).
``hashmap_get`` is K8 (``csrc/hashmap.cu``) on a CUDA tensor and
``hashmap_get_plain`` on a CPU tensor: ``torch.searchsorted`` over the
decoded keys, sign-flipped so that int64 order is the unsigned order, a
gather and a compare (``searchsorted_get``, also the library yardstick of
``chip_smoke.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rkmh_tpu_torch.ops import kernels

MIN_BITS = 8
_FLIP = -(2**63)  # int64 ^ _FLIP orders as the uint64 it holds


def bucket_bits(n: int) -> int:
    return max(MIN_BITS, int(n).bit_length() - 2)


@dataclass(frozen=True, eq=False)
class SortedMap:
    """words [n] | ov_keys [m] | dir [2**bits + 1] and ov_values [m] as
    int32 pairs, in one int64 tensor ``buf``."""

    buf: torch.Tensor
    bits: int
    n: int
    m: int

    @property
    def words(self) -> torch.Tensor:
        return self.buf[: self.n]

    @property
    def ov_keys(self) -> torch.Tensor:
        return self.buf[self.n : self.n + self.m]

    @property
    def dir(self) -> torch.Tensor:
        return self.buf[self.n + self.m :].view(torch.int32)[: (1 << self.bits) + 1]

    @property
    def ov_values(self) -> torch.Tensor:
        d = (1 << self.bits) + 1
        return self.buf[self.n + self.m :].view(torch.int32)[d : d + self.m]

    @property
    def device(self) -> torch.device:
        return self.buf.device

    def to(self, device) -> "SortedMap":
        return SortedMap(self.buf.to(device), self.bits, self.n, self.m)

    def part_bytes(self) -> dict:
        return {"words": 8 * self.n, "directory": 4 * ((1 << self.bits) + 1),
                "overflow": 12 * self.m}


def buf_len(bits: int, n: int, m: int) -> int:
    return n + m + ((1 << bits) + 1 + m + 1) // 2


def build_sorted_map(keys: np.ndarray, values: np.ndarray) -> SortedMap:
    """keys: uint64, unique and sorted (``np.unique``'s order); values:
    int32 (counts) -> the map on the CPU."""
    keys = np.asarray(keys, dtype=np.uint64)
    v = np.asarray(values).astype(np.int64)
    if keys.ndim != 1 or v.shape != keys.shape:
        raise ValueError(f"keys and values are two [n] arrays, got {keys.shape} and {v.shape}")
    if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError("the keys must be unique and sorted")
    if v.size and (v.min() < -2**31 or v.max() >= 2**31):
        raise ValueError("the values must fit int32")
    n = keys.size
    if n >= 2**31:
        raise ValueError(f"a map holds fewer than 2**31 keys, got {n}")
    bits = bucket_bits(n)
    sat = (1 << bits) - 1
    over = (v < 0) | (v >= sat)
    m = int(over.sum())
    words = (keys << np.uint64(bits)) | np.where(over, sat, v).astype(np.uint64)
    i32 = np.zeros(2 * (buf_len(bits, n, m) - n - m), dtype=np.int32)
    np.cumsum(np.bincount((keys >> np.uint64(64 - bits)).astype(np.int64), minlength=1 << bits),
              out=i32[1 : (1 << bits) + 1])
    i32[(1 << bits) + 1 : (1 << bits) + 1 + m] = v[over]
    buf = np.concatenate([words.view(np.int64), keys[over].view(np.int64), i32.view(np.int64)])
    return SortedMap(torch.from_numpy(buf), bits, n, m)


def unique_counts(hashes: np.ndarray, mask: np.ndarray | None = None):
    """(keys, counts) over the window hashes (the mask's, if given): the
    read depth of rkmh.cpp:1616-1623.  Zeros count too: every invalid
    read k-mer adds to map[0], as the reference's operator[] loop does."""
    h = np.asarray(hashes)
    h = h.view(np.uint64) if h.dtype == np.int64 else h.astype(np.uint64, copy=False)
    if mask is not None:
        h = h[np.asarray(mask, dtype=bool)]
    keys, counts = np.unique(h, return_counts=True)
    return keys, counts.astype(np.int32)


def depth_map_from_hashes(hashes: np.ndarray, mask: np.ndarray | None = None) -> SortedMap:
    """The read depth map of the hashes (``unique_counts``), on the CPU."""
    return build_sorted_map(*unique_counts(hashes, mask))


def check_map(sm: SortedMap) -> SortedMap:
    """Raises on anything but a map's layout: one contiguous 1-D int64
    buffer of the length its bits, n and m give."""
    if not isinstance(sm, SortedMap):
        raise ValueError(f"a depth map is a SortedMap, got {type(sm).__name__}")
    b = sm.buf
    if b.dtype != torch.int64 or b.dim() != 1 \
            or not b.is_contiguous() or not 1 <= sm.bits <= 31 or not 0 <= sm.m <= sm.n \
            or b.numel() != buf_len(sm.bits, sm.n, sm.m):
        raise ValueError("a depth map is one contiguous [n + m + (2**bits + 2 + m) // 2] int64 "
                         f"buffer, got {tuple(b.shape)} {b.dtype} with bits={sm.bits}, "
                         f"n={sm.n}, m={sm.m}")
    return sm


def sorted_keys(sm: SortedMap) -> tuple[torch.Tensor, torch.Tensor]:
    """(the keys in order, sign-flipped into int64 order; their values)."""
    check_map(sm)
    B, w, dev = sm.bits, sm.words, sm.device
    bucket = torch.repeat_interleave(torch.arange(1 << B, device=dev), sm.dir.diff().long())
    keys = ((w >> B) & ((1 << (64 - B)) - 1)) | (bucket << (64 - B))
    values = (w & ((1 << B) - 1)).to(torch.int32)
    over = values == (1 << B) - 1
    if int(over.sum()) != sm.m:
        raise ValueError(f"a map with {sm.m} overflow entries has {int(over.sum())} "
                         "saturated counts")
    values[over] = sm.ov_values
    return keys ^ _FLIP, values


def searchsorted_get(flipped: torch.Tensor, values: torch.Tensor,
                     hashes: torch.Tensor) -> torch.Tensor:
    """The values of the hashes (any shape), 0 where absent: ``flipped``
    the sorted sign-flipped keys, ``values`` theirs."""
    q = hashes ^ _FLIP
    if flipped.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    i = torch.searchsorted(flipped, q).clamp(max=flipped.numel() - 1)
    return torch.where(flipped[i] == q, values[i], torch.zeros_like(values[i]))


def hashmap_get_plain(sm: SortedMap, hashes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch lookup: [...] int64 keys -> [...] int32 values, 0 for
    a missing key."""
    return searchsorted_get(*sorted_keys(sm), hashes.to(torch.int64))


def _hashmap_get_cuda(sm: SortedMap, hashes: torch.Tensor) -> torch.Tensor:
    """K8 wrapper."""
    check_map(sm)
    if hashes.dtype != torch.int64 or hashes.device != sm.device:
        raise ValueError(f"hash-map kernel takes int64 keys on the map's device, got "
                         f"{hashes.dtype} on {hashes.device}")
    keys = hashes.contiguous()
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if keys.numel():
        kernels.HASHMAP_GET(keys, keys.numel(), *map_args(sm), out)
    return out


def map_args(sm: SortedMap) -> tuple:
    """The map's arguments of the C entry points: words, dir, ov_keys,
    ov_values, m, bits."""
    return sm.words, sm.dir, sm.ov_keys, sm.ov_values, sm.m, sm.bits


def hashmap_get(sm: SortedMap, hashes: torch.Tensor) -> torch.Tensor:
    """The value of every key (0 where absent): K8 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if hashes.device.type == "cuda":
        return _hashmap_get_cuda(sm, hashes)
    if hashes.device.type != "cpu":
        raise ValueError(f"no hash-map path for device {hashes.device}")
    return hashmap_get_plain(sm, hashes)
