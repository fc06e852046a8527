"""Inputs of call's kernels at the shapes its path gives them, for
``chip_smoke.py`` and ``bench/kernel_ab.py``.

* the synthetic call workload (``synth.write_call_workload``: HPV16REF,
  ~7.9 kb, and 1,100 nanopore-like reads of a sample with planted
  variants), its depth map built as ``call`` builds it (K1, then
  ``np.unique`` and the sorted map's layout) and the reference's codes,
  k = 16;
* the first 2**20 read k-mer hashes (every one in the map);
* a 1 Mbp reference made from a seed (runs of N in it), scanned against
  the same map: 64M mutated k-mers at k = 16;
* a map ~10x the card's L2 (``big_map``: 50M keys made from a seed, 465
  MB) and 2**20 queries of it, half of them keys.

The library yardstick of a map lookup is ``ops/hashmap.searchsorted_get``:
``torch.searchsorted`` over the map's keys, sorted as unsigned
(sign-flipped int64), a gather and a compare, as ``search`` tests
membership.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch import call_engine, synth
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.call_cmd import build_depth_map
from rkmh_tpu_torch.commands.common import bucketed_batches, load_packed, load_records
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops.hashmap import SortedMap, build_sorted_map, hashmap_get

CALL_K = 16
CALL_W = 100
BIG_REF_LEN = 1_000_000
READ_QUERIES = 1 << 20
BIG_MAP_KEYS = 50_000_000


def ref_codes(seq: bytes, device) -> torch.Tensor:
    return torch.from_numpy(encode_seqs([seq])[0][0, : len(seq)].copy()).to(device)


def big_reference(device, n: int = BIG_REF_LEN, seed: int = 3) -> torch.Tensor:
    """[n] codes made from a seed, with a run of 50 N every ~100 kb."""
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    for start in range(50_000, n, 100_000):
        codes[start : start + 50] = 4
    return torch.from_numpy(codes).to(device)


def read_hashes(reads_path: str, device, n: int = READ_QUERIES, k: int = CALL_K):
    """The first n window hashes of the reads (K1), those the map holds."""
    out, have = [], 0
    for _, codes, lens in bucketed_batches(load_packed([reads_path]), 256):
        hashes, mask = engine.hash_batch_with_mask(
            torch.from_numpy(codes).to(device), torch.from_numpy(lens).to(device), (k,))
        out.append(hashes[mask])
        have += out[-1].numel()
        if have >= n:
            break
    return torch.cat(out)[:n]


def call_workload(device, tmp: str) -> dict:
    """The workload's files, map and codes (see the module's docstring)."""
    ref, reads, truth, variants = synth.write_call_workload(tmp)
    stats: dict = {}
    table = build_depth_map(load_packed([reads]), (CALL_K,), 2048, device, stats)
    seq = load_records([ref])[0].seq
    return {"ref": ref, "reads": reads, "truth": truth, "variants": variants, "table": table,
            "map_stats": stats, "codes": ref_codes(seq, device),
            "read_hashes": read_hashes(reads, device), "big": big_reference(device)}


def scan_inputs(codes: torch.Tensor, table: SortedMap, k: int = CALL_K, w: int = CALL_W):
    """(depth, avg, site) of a reference row, as call_scan_ref makes them."""
    depth = hashmap_get(table, call_engine.positional_hashes(codes, k))
    return (depth, *call_engine.window_average(depth, w))


def big_map(device, n: int = BIG_MAP_KEYS, queries: int = READ_QUERIES, seed: int = 5):
    """(a map of n keys spread over the uint64 range, made from a seed
    without a sort: the running sum of random gaps; counts 1..60, every
    1000th 2**30 (in the overflow); queries, half of them keys)."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(1, int(1.9 * 2**64 / n), size=n, dtype=np.uint64)
    keys = np.cumsum(gaps, dtype=np.uint64)
    counts = rng.integers(1, 61, size=n).astype(np.int32)
    counts[::1000] = 2**30
    q = np.concatenate([rng.choice(keys, queries // 2),
                        rng.integers(0, 2**64 - 1, size=queries - queries // 2, dtype=np.uint64,
                                     endpoint=True)])
    return (build_sorted_map(keys, counts).to(device),
            torch.from_numpy(q[rng.permutation(queries)].view(np.int64)).to(device))
