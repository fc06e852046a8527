"""Read hashes from a seed for the depth map's device build
(``ops/hashmap.sorted_map_from_hashes``), at the edges of its layout.

Each case is an int64 array of hashes (uint64 bit patterns), every
occurrence counted as ``call`` counts them:

* ``duplicates``: 60,000 draws of 2,000 keys, skewed, so that most keys
  repeat and a few pass a word's count;
* ``zeros``: 40% zeros among random hashes, as invalid read k-mers give:
  key 0's count overflows;
* ``sign_edges``: keys at and around 0, 2**63 - 1, 2**63 and 2**64 - 1,
  each repeated, among random ones;
* ``saturation``: 300 keys (B = 8, a word's count saturates at 255), three
  of them counted 254, 255 and 256 times;
* ``step_below``, ``step_at``: 1,023 and 1,024 keys, the two sides of
  ``bucket_bits``' step from 8 to 9 bits;
* ``one``, ``all_equal``, ``empty``: one hash, 500 copies of one hash (a
  key at or above 2**63), none.

The CPU tests hold the torch build to ``build_sorted_map(*unique_counts(h))``
on them, the card tests do the same on CUDA tensors.  ``reads_depth_map``
is the numpy build of a read set's map, which they hold
``call_cmd.build_depth_map`` to.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.ops import hashmap

CASES = ("duplicates", "zeros", "sign_edges", "saturation", "step_below", "step_at", "one",
         "all_equal", "empty")


def _distinct(rng: np.random.Generator, n: int) -> np.ndarray:
    """n distinct int64 keys spread over all 64 bits, in random order."""
    keys = np.zeros(0, np.int64)
    while keys.size < n:
        keys = np.unique(np.concatenate([keys, rng.integers(
            -2**63, 2**63 - 1, size=n, dtype=np.int64, endpoint=True)]))
    return rng.permutation(keys)[:n]


def _repeat(keys: np.ndarray, counts, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(np.repeat(keys, counts))


def hash_case(name: str, seed: int = 0) -> np.ndarray:
    """The case's hashes [N] int64, made from ``seed``."""
    rng = np.random.default_rng([seed, CASES.index(name)])
    if name == "duplicates":
        keys = _distinct(rng, 2000)
        p = 1.0 / np.arange(1, keys.size + 1)
        return rng.choice(keys, size=60_000, p=p / p.sum())
    if name == "zeros":
        h = _distinct(rng, 20_000)
        h[rng.random(h.size) < 0.4] = 0
        return h
    if name == "sign_edges":
        edges = np.array([0, 1, -1, -2, 2**63 - 1, 2**63 - 2, -2**63, -2**63 + 1],
                         dtype=np.int64)
        keys = np.unique(np.concatenate([edges, _distinct(rng, 500)]))
        return _repeat(keys, rng.integers(1, 6, size=keys.size), rng)
    if name == "saturation":
        keys = _distinct(rng, 300)
        counts = rng.integers(1, 11, size=keys.size)
        counts[:3] = (254, 255, 256)
        return _repeat(keys, counts, rng)
    if name in ("step_below", "step_at"):
        keys = _distinct(rng, 1023 if name == "step_below" else 1024)
        return _repeat(keys, rng.integers(1, 4, size=keys.size), rng)
    if name == "one":
        return np.array([0x1234_5678_9ABC_DEF], dtype=np.int64)
    if name == "all_equal":
        return np.full(500, -0x0123_4567_89AB_CDEF, dtype=np.int64)
    if name == "empty":
        return np.zeros(0, np.int64)
    raise ValueError(f"no hash case {name!r}")


def reads_depth_map(reads, ks) -> hashmap.SortedMap:
    """The depth map of packed ``reads`` built in numpy on the host: their
    window hashes computed on the CPU in one batch, then
    ``hashmap.depth_map_from_hashes``."""
    hashes, mask = engine.hash_batch_with_mask(torch.from_numpy(reads.codes),
                                               torch.from_numpy(reads.lens), ks)
    return hashmap.depth_map_from_hashes(hashes.numpy(), mask.numpy())
