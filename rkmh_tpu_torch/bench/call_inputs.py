"""Inputs of call's kernels at the shapes its path gives them, for
``chip_smoke.py`` and ``bench/kernel_ab.py``.

* the synthetic call workload (``synth.write_call_workload``: HPV16REF,
  ~7.9 kb, and 1,100 nanopore-like reads of a sample with planted
  variants), its depth map built as ``call`` builds it (K1, then the host
  cuckoo build) and the reference's codes, k = 16;
* the first 2**20 read k-mer hashes (every one in the map);
* a 1 Mbp reference made from a seed (runs of N in it), scanned against
  the same map: 64M mutated k-mers at k = 16;
* the library yardstick of a map lookup: ``torch.searchsorted`` over the
  map's keys, sorted as unsigned (sign-flipped int64), a gather and a
  compare, as ``search`` tests membership.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch import call_engine, synth
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.call_cmd import build_depth_map
from rkmh_tpu_torch.commands.common import bucketed_batches, load_packed, load_records
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops.hashmap import hashmap_get
from rkmh_tpu_torch.ops.lookup import M32

CALL_K = 16
CALL_W = 100
BIG_REF_LEN = 1_000_000
READ_QUERIES = 1 << 20
_FLIP = -(2**63)


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


def scan_inputs(codes: torch.Tensor, table: torch.Tensor, k: int = CALL_K, w: int = CALL_W):
    """(depth, avg, site) of a reference row, as call_scan_ref makes them."""
    depth = hashmap_get(table, call_engine.positional_hashes(codes, k))
    return (depth, *call_engine.window_average(depth, w))


def sorted_map(table: torch.Tensor):
    """(the map's keys as sign-flipped int64, sorted; their values)."""
    used = table[:, 3] != 0
    keys = ((table[used, 0].to(torch.int64) & M32) << 32) | (table[used, 1].to(torch.int64) & M32)
    flipped, order = torch.sort(keys ^ _FLIP)
    return flipped, table[used, 2][order]


def searchsorted_get(flipped: torch.Tensor, values: torch.Tensor,
                     hashes: torch.Tensor) -> torch.Tensor:
    """The library yardstick of a lookup: values of the hashes, 0 where absent."""
    q = hashes ^ _FLIP
    i = torch.searchsorted(flipped, q).clamp(max=flipped.numel() - 1)
    return torch.where(flipped[i] == q, values[i], torch.zeros_like(values[i]))
