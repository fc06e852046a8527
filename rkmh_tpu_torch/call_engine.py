"""Variant-calling engine: positional depth and every 1-bp mutation of
every reference window, on the device.

Counterpart of ``rkmh_tpu/call_engine.py``.  rkmh's ``call``
(rkmh.cpp:1455-1904) walks each reference position with a sliding depth
window and, at low-depth sites, hashes every 1-bp substitution (k
positions x 3 bases) and deletion (k positions of the flanking (k+1)-mer)
and looks its depth up in the exact read-depth map.  Here the whole
reference goes at once:

* positional hashes [P]: K1 (``ops/hashing``) on the reference, as rows of
  at most ``ROW_WINDOWS`` windows that overlap by k-1 codes, so any length
  fits the kernel's grid;
* depth[j] = map[hash[j]]: K8 (``ops/hashmap``; the map is a
  ``SortedMap``, the read hashes' keys sorted under a directory);
* the trailing-window average [P] (int64 cumulative sums, float64
  division truncated to int32, as rkmh's ``int avg_d = (double)sum /
  size``) and the sites (``depth < 0.5 * avg``): PyTorch glue, as in the
  JAX package;
* the mutation scan: K9 (``csrc/call_scan.cu``), which makes, hashes,
  probes and calls every variant without materialising them: its packed
  route for k <= 32, its byte-wise route above (or where the caller asks
  for it, ``route="bytewise"``, to time or check it).

On a CPU tensor ``call_scan_ref`` is ``call_scan_plain``, the JAX chain
step by step in PyTorch (``rkmh_tpu/call_engine.py:60-123``; the mutated
k-mers built as [N, k] rows and hashed by ``kmer_window_hashes_plain``).
Float comparisons are in float64, as rkmh.cpp's doubles: site if depth <
0.5*avg (rkmh.cpp:1801); SNP call if alt_depth >= 0.1*avg && alt_depth >
depth (1814); DEL call if alt_depth > 0.9*avg (1858).  The JAX package's
quirks stay: an invalid window's depth is map[0]; an N origin's
substitutions are not called but count in ``max_rescue``; DELs only for j
> 0; the caller's pos = j + alt_pos + 1 for both kinds.

Unlike the JAX package, the reference row is not padded to a bucket
length: P = L - k + 1 exactly.

``call_scan_slice`` scans a slice of a reference's positions, as ``call
--devices`` cuts them (``parallel/mesh.ShardedCallScan``,
``rkmh_tpu/parallel/mesh.py:553-660``): the window average reads the
previous slice's last w depths as a halo and sizes its window on the
global index, and K9 (or the plain enumeration) guards a deletion on the
global index (its ``base``).  ``call_scan_ref`` is the slice that starts at
0 and holds every position.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.io.packing import PAD_CODE
from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes, kmer_window_hashes_plain
from rkmh_tpu_torch.ops.hashmap import (
    SortedMap, check_map, hashmap_get, map_args, searchsorted_get, sorted_keys,
)

# rotate_snps order (rkmh.cpp:1634-1654), in 2-bit codes A=0 C=1 G=2 T=3:
# A->(C,T,G)  C->(T,G,A)  G->(A,C,T)  T->(C,G,A)
ROT = np.array([[1, 3, 2], [3, 2, 0], [0, 1, 3], [1, 2, 0]], dtype=np.uint8)

ROW_WINDOWS = 1 << 22       # positional windows per K1 row (its limit: ~8.4M codes a row)
MAX_PACKED_K = 32           # K9's packed route takes k <= 32
PLAIN_CHUNK = 2048          # positions per step of the plain enumeration
_PAD = 4                    # the deletion window's code before ref[0]


def positional_hashes(ref_codes: torch.Tensor, k: int,
                      row_windows: int = ROW_WINDOWS) -> torch.Tensor:
    """[L] uint8 codes -> [P] int64 window hashes (K1 on a CUDA tensor),
    the row split into rows of ``row_windows`` windows overlapping by k-1
    codes (the last padded with invalid codes, whose windows are cut)."""
    L = ref_codes.shape[0]
    P = L - k + 1
    if P <= row_windows:
        return kmer_window_hashes(ref_codes[None], k)[0]
    n = -(-P // row_windows)
    padded = torch.full((n * row_windows + k - 1,), int(PAD_CODE), dtype=torch.uint8,
                        device=ref_codes.device)
    padded[:L] = ref_codes
    rows = padded.unfold(0, row_windows + k - 1, row_windows).contiguous()
    return kmer_window_hashes(rows, k).reshape(-1)[:P]


def window_average(depth: torch.Tensor, window_len: int, halo: torch.Tensor | None = None,
                   base: int = 0):
    """(avg [P] int32, site [P] bool): the trailing-window average over
    [max(0, j-w+1), j], truncated like rkmh's ``int avg_d = (double)sum /
    (double)size`` (rkmh.cpp:1626-1633), and the sites, depth < 0.5*avg
    (rkmh.cpp:1801).  For a slice of a reference whose position 0 is the
    global position ``base``: ``halo``, the w depths before it (None:
    zeros, as before position 0), and the window size min(base + j + 1, w)
    on the global index (``rkmh_tpu/parallel/mesh.py:585-597``)."""
    P, w = depth.shape[0], window_len
    if halo is None:
        halo = torch.zeros(w, dtype=depth.dtype, device=depth.device)
    if halo.shape != (w,):
        raise ValueError(f"the halo holds the {w} depths before the slice, got {tuple(halo.shape)}")
    cs = torch.cumsum(torch.cat([halo, depth]).to(torch.int64), 0)  # [w + P]
    j = torch.arange(P, device=depth.device)
    wsize = torch.clamp(base + j + 1, max=w)
    wsum = cs[w + j] - cs[w + j - wsize]  # the wsize depths ending at j (w + j - wsize >= 0)
    avg = (wsum.to(torch.float64) / wsize.to(torch.float64)).to(torch.int32)
    site = depth.to(torch.float64) < 0.5 * avg.to(torch.float64)
    return avg, site


def snp_codes(win: torch.Tensor) -> torch.Tensor:
    """Windows [n, k] uint8 -> every 1-bp substitution of each, [n, k, 3, k]:
    position p of window j takes ROT's three alternatives of its code (an
    invalid code's as T's), as ``rkmh_tpu/call_engine.py:80-90`` builds them."""
    k = win.shape[1]
    alts = torch.from_numpy(ROT).to(win.device)[win.clamp(max=3).long()]  # [n, k, 3]
    eye = torch.eye(k, dtype=torch.bool, device=win.device)
    return torch.where(eye[None, :, None, :], alts[:, :, :, None], win[:, None, None, :])


def mutation_hashes(ref_codes: torch.Tensor, k: int, j0: int, j1: int, lead: int = _PAD):
    """The mutated k-mers of positions [j0, j1), built as the JAX chain
    builds them (call_engine.py:79-93, 106-114) and hashed as [N, k] rows
    by the plain hash: (win [n, k], snp_hash [n, k, 3], del_hash [n, k]).
    ``lead``: the code before ref_codes[0] (a pad code at a reference's
    start, the previous code in a slice)."""
    n = j1 - j0
    dev = ref_codes.device
    win = ref_codes[j0 : j1 + k - 1].unfold(0, k, 1)                # [n, k]
    snp_hash = kmer_window_hashes_plain(snp_codes(win).reshape(-1, k), k)[:, 0].reshape(n, k, 3)
    # d_alt = ref[j-1 .. j+k] (k+1 codes, a pad code before ref[0]); drop
    # position ap in 1..k
    padded = torch.cat([torch.full((1,), lead, dtype=torch.uint8, device=dev), ref_codes])
    dwin = padded[j0 : j1 + k].unfold(0, k + 1, 1)                  # [n, k+1]
    del_codes = torch.stack([torch.cat([dwin[:, :ap], dwin[:, ap + 1 :]], dim=-1)
                             for ap in range(1, k + 1)], dim=1)      # [n, k, k]
    del_hash = kmer_window_hashes_plain(del_codes.reshape(-1, k), k)[:, 0].reshape(n, k)
    return win, snp_hash, del_hash


def _enumerate_plain(ref_codes, get, k, depth, avg, site, j0, j1, base: int = 0,
                     lead: int = _PAD):
    """The JAX chain's SNP and DEL calls (call_engine.py:94-118) for
    positions [j0, j1); ``get`` maps hashes to their depths.  A slice
    whose position 0 is the global ``base`` guards its deletions by base +
    j > 0; ``lead`` is as in ``mutation_hashes``."""
    win, snp_hash, del_hash = mutation_hashes(ref_codes, k, j0, j1, lead)
    snp_depth = get(snp_hash)                                         # [n, k, 3]
    d, a, s = depth[j0:j1], avg[j0:j1].to(torch.float64), site[j0:j1]
    snp_call = (s[:, None, None] & (snp_depth.to(torch.float64) >= 0.1 * a[:, None, None])
                & (snp_depth > d[:, None, None]) & (win < 4)[:, :, None])
    max_rescue = torch.where(s[:, None, None], snp_depth,
                             torch.zeros_like(snp_depth)).amax(dim=(1, 2))
    del_depth = get(del_hash)
    j = torch.arange(base + j0, base + j1, device=ref_codes.device)
    del_call = (s[:, None] & (del_depth.to(torch.float64) > 0.9 * a[:, None])
                & (j > 0)[:, None])
    return snp_depth, snp_call, max_rescue.to(torch.int32), del_depth, del_call


def positional_depths(ref_codes: torch.Tensor, table: SortedMap, k: int,
                      get=None) -> torch.Tensor:
    """[L] uint8 codes -> the depth in the map of each of their L - k + 1
    windows: K1 and K8 on a CUDA tensor; with ``get`` (``plain_getter``)
    the plain hash and lookup."""
    if get is not None:
        return get(kmer_window_hashes_plain(ref_codes[None], k)[0])
    return hashmap_get(table, positional_hashes(ref_codes, k))


def plain_getter(table: SortedMap):
    """The plain lookup of a map, its keys decoded once."""
    flipped, values = sorted_keys(table)
    return lambda hashes: searchsorted_get(flipped, values, hashes)


def call_scan_plain(ref_codes: torch.Tensor, table: SortedMap, k: int,
                    window_len: int) -> dict:
    """Plain PyTorch version of ``call_scan_ref`` (on any device): the JAX
    chain step by step, the enumeration in chunks of PLAIN_CHUNK positions."""
    return call_scan_slice(_with_pad(ref_codes), table, k, window_len,
                           ref_codes.shape[0] - k + 1, plain=True)


def _with_pad(ref_codes: torch.Tensor) -> torch.Tensor:
    """A reference row with the pad code before it (K9's ``pref``)."""
    return torch.cat([torch.full((1,), _PAD, dtype=torch.uint8, device=ref_codes.device),
                      ref_codes])


def _call_scan_cuda(ref_codes, table, k, depth, avg, site, route: str | None = None):
    """K9 wrapper: (snp_depth, snp_call, max_rescue, del_depth, del_call)
    of a whole reference row.  ``route``: None takes the packed route for k
    <= 32 and the byte-wise one above; "bytewise" the byte-wise route at
    any k."""
    return _call_scan_pref_cuda(_with_pad(ref_codes), table, k, depth, avg, site, route)


def _call_scan_pref_cuda(pref, table, k, depth, avg, site, route: str | None = None,
                         base: int = 0):
    """K9 on the P = len(depth) positions of ``pref``: [P + k] (at least)
    uint8 codes, the code before position 0 (a pad code at a reference's
    start), then the positions' codes; ``base``: the global index of
    position 0 (a deletion is called only at a global index > 0)."""
    if route not in (None, "bytewise"):
        raise ValueError(f"K9 has no route {route!r}")
    if check_map(table).device != pref.device:
        raise ValueError(f"the map is on {table.device}, the codes on {pref.device}")
    P = depth.shape[0]
    if pref.dtype != torch.uint8 or pref.dim() != 1 or pref.shape[0] < P + k or base < 0:
        raise ValueError(f"K9 takes [>= P + k] uint8 codes and base >= 0, got "
                         f"{tuple(pref.shape)} {pref.dtype} for P = {P}, k = {k}, base {base}")
    bytewise = route == "bytewise" or k > MAX_PACKED_K
    dev = pref.device
    pref = pref.contiguous()
    snp_depth = torch.empty((P, k, 3), dtype=torch.int32, device=dev)
    snp_call = torch.empty((P, k, 3), dtype=torch.bool, device=dev)
    max_rescue = torch.empty(P, dtype=torch.int32, device=dev)
    del_depth = torch.empty((P, k), dtype=torch.int32, device=dev)
    del_call = torch.empty((P, k), dtype=torch.bool, device=dev)
    kernels.CALL_SCAN(pref, P, k, depth.contiguous(), avg.contiguous(), site.contiguous(),
                      *map_args(table), snp_depth, snp_call, max_rescue, del_depth, del_call,
                      base, int(bytewise), route="bytewise" if bytewise else "packed")
    return snp_depth, snp_call, max_rescue, del_depth, del_call


def call_scan_slice(pref: torch.Tensor, table: SortedMap, k: int, window_len: int, P: int,
                    base: int = 0, halo: torch.Tensor | None = None,
                    plain: bool | None = None) -> dict:
    """``call_scan_ref``'s dict for the P positions [base, base + P) of a
    reference, from ``pref`` [>= P + k] uint8: the code before position
    ``base`` (a pad code at base 0), then the codes from there on (the
    slice and its k-halo; ``rkmh_tpu/parallel/mesh.py:553-660``).  ``halo``:
    the depths of the w positions before the slice (None: zeros).  K1,
    K8, the window average and K9 at the slice's offset on a CUDA tensor;
    the plain versions on a CPU tensor, or anywhere with ``plain``."""
    if plain is None:
        if pref.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no call-scan path for device {pref.device}")
        plain = pref.device.type == "cpu"
    ref = pref[1:]
    get = plain_getter(table) if plain else None
    depth = positional_depths(ref[: P + k - 1], table, k, get)
    avg, site = window_average(depth, window_len, halo, base)
    if not plain:
        mut = _call_scan_pref_cuda(pref, table, k, depth, avg, site, base=base)
    else:
        lead = int(pref[0])
        parts = [_enumerate_plain(ref, get, k, depth, avg, site, j0, min(j0 + PLAIN_CHUNK, P),
                                  base, lead) for j0 in range(0, P, PLAIN_CHUNK)]
        mut = [torch.cat([p[i] for p in parts]) for i in range(5)]
    names = ("snp_depth", "snp_call", "max_rescue", "del_depth", "del_call")
    return dict(depth=depth, avg=avg, site=site, **dict(zip(names, mut)))


def call_scan_ref(ref_codes: torch.Tensor, table: SortedMap, k: int,
                  window_len: int) -> dict:
    """One reference row -> what the caller needs.

    ref_codes: [L] uint8 (A=0 C=1 G=2 T=3, >= 4 invalid), L >= k; table:
    the depth map (``ops/hashmap.SortedMap``) on the same device.  Returns the
    JAX function's dict: depth, avg, site [P]; snp_depth, snp_call [P, k,
    3]; max_rescue [P]; del_depth, del_call [P, k] (P = L - k + 1).  On a
    CUDA tensor: K1, K8, the glue, K9; on a CPU tensor: call_scan_plain."""
    if ref_codes.dtype != torch.uint8 or ref_codes.dim() != 1 or ref_codes.shape[0] < k or k < 1:
        raise ValueError(f"call scan takes [L] uint8 codes with L >= k >= 1, got "
                         f"{tuple(ref_codes.shape)} {ref_codes.dtype}, k={k}")
    if ref_codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no call-scan path for device {ref_codes.device}")
    return call_scan_slice(_with_pad(ref_codes), table, k, window_len,
                           ref_codes.shape[0] - k + 1)
