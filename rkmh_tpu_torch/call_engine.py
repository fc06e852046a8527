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
* depth[j] = map[hash[j]]: K8 (``ops/hashmap``);
* the trailing-window average [P] (int64 cumulative sums, float64
  division truncated to int32, as rkmh's ``int avg_d = (double)sum /
  size``) and the sites (``depth < 0.5 * avg``): PyTorch glue, as in the
  JAX package;
* the mutation scan: K9 (``csrc/call_scan.cu``), which makes, hashes,
  probes and calls every variant without materialising them.

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
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.io.packing import PAD_CODE
from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes, kmer_window_hashes_plain
from rkmh_tpu_torch.ops.hashmap import device_table_size, hashmap_get, hashmap_get_plain

# rotate_snps order (rkmh.cpp:1634-1654), in 2-bit codes A=0 C=1 G=2 T=3:
# A->(C,T,G)  C->(T,G,A)  G->(A,C,T)  T->(C,G,A)
ROT = np.array([[1, 3, 2], [3, 2, 0], [0, 1, 3], [1, 2, 0]], dtype=np.uint8)

ROW_WINDOWS = 1 << 22       # positional windows per K1 row (its limit: ~8.4M codes a row)
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


def window_average(depth: torch.Tensor, window_len: int):
    """(avg [P] int32, site [P] bool): the trailing-window average over
    [max(0, j-w+1), j], truncated like rkmh's ``int avg_d = (double)sum /
    (double)size`` (rkmh.cpp:1626-1633), and the sites, depth < 0.5*avg
    (rkmh.cpp:1801)."""
    P = depth.shape[0]
    cs = torch.cumsum(depth.to(torch.int64), 0)
    j = torch.arange(P, device=depth.device)
    lo_idx = j - window_len
    lo = torch.where(lo_idx >= 0, cs[lo_idx.clamp(min=0)], torch.zeros_like(cs))
    wsize = torch.clamp(j + 1, max=window_len)
    avg = ((cs - lo).to(torch.float64) / wsize.to(torch.float64)).to(torch.int32)
    site = depth.to(torch.float64) < 0.5 * avg.to(torch.float64)
    return avg, site


def mutation_hashes(ref_codes: torch.Tensor, k: int, j0: int, j1: int):
    """The mutated k-mers of positions [j0, j1), built as the JAX chain
    builds them (call_engine.py:79-93, 106-114) and hashed as [N, k] rows
    by the plain hash: (win [n, k], snp_hash [n, k, 3], del_hash [n, k])."""
    n = j1 - j0
    dev = ref_codes.device
    win = ref_codes[j0 : j1 + k - 1].unfold(0, k, 1)                # [n, k]
    rot = torch.from_numpy(ROT).to(dev)
    alts = rot[win.clamp(max=3).long()]                               # [n, k, 3]
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    alt_codes = torch.where(eye[None, :, None, :], alts[:, :, :, None],
                            win[:, None, None, :])                    # [n, k, 3, k]
    snp_hash = kmer_window_hashes_plain(alt_codes.reshape(-1, k), k)[:, 0].reshape(n, k, 3)
    # d_alt = ref[j-1 .. j+k] (k+1 codes, a pad code before ref[0]); drop
    # position ap in 1..k
    padded = torch.cat([torch.full((1,), _PAD, dtype=torch.uint8, device=dev), ref_codes])
    dwin = padded[j0 : j1 + k].unfold(0, k + 1, 1)                  # [n, k+1]
    del_codes = torch.stack([torch.cat([dwin[:, :ap], dwin[:, ap + 1 :]], dim=-1)
                             for ap in range(1, k + 1)], dim=1)      # [n, k, k]
    del_hash = kmer_window_hashes_plain(del_codes.reshape(-1, k), k)[:, 0].reshape(n, k)
    return win, snp_hash, del_hash


def _enumerate_plain(ref_codes, table, k, depth, avg, site, j0, j1):
    """The JAX chain's SNP and DEL calls (call_engine.py:94-118) for
    positions [j0, j1)."""
    win, snp_hash, del_hash = mutation_hashes(ref_codes, k, j0, j1)
    snp_depth = hashmap_get_plain(table, snp_hash)                    # [n, k, 3]
    d, a, s = depth[j0:j1], avg[j0:j1].to(torch.float64), site[j0:j1]
    snp_call = (s[:, None, None] & (snp_depth.to(torch.float64) >= 0.1 * a[:, None, None])
                & (snp_depth > d[:, None, None]) & (win < 4)[:, :, None])
    max_rescue = torch.where(s[:, None, None], snp_depth,
                             torch.zeros_like(snp_depth)).amax(dim=(1, 2))
    del_depth = hashmap_get_plain(table, del_hash)
    j = torch.arange(j0, j1, device=ref_codes.device)
    del_call = (s[:, None] & (del_depth.to(torch.float64) > 0.9 * a[:, None])
                & (j > 0)[:, None])
    return snp_depth, snp_call, max_rescue.to(torch.int32), del_depth, del_call


def call_scan_plain(ref_codes: torch.Tensor, table: torch.Tensor, k: int,
                    window_len: int) -> dict:
    """Plain PyTorch version of ``call_scan_ref``: the JAX chain step by
    step, the enumeration in chunks of PLAIN_CHUNK positions."""
    P = ref_codes.shape[0] - k + 1
    wh = kmer_window_hashes_plain(ref_codes[None], k)[0]
    depth = hashmap_get_plain(table, wh)
    avg, site = window_average(depth, window_len)
    parts = [_enumerate_plain(ref_codes, table, k, depth, avg, site, j0,
                              min(j0 + PLAIN_CHUNK, P)) for j0 in range(0, P, PLAIN_CHUNK)]
    names = ("snp_depth", "snp_call", "max_rescue", "del_depth", "del_call")
    return dict(depth=depth, avg=avg, site=site,
                **{name: torch.cat([p[i] for p in parts]) for i, name in enumerate(names)})


def _call_scan_cuda(ref_codes, table, k, depth, avg, site):
    """K9 wrapper: (snp_depth, snp_call, max_rescue, del_depth, del_call)."""
    T = device_table_size(table)
    P = ref_codes.shape[0] - k + 1
    dev = ref_codes.device
    pref = torch.cat([torch.full((1,), _PAD, dtype=torch.uint8, device=dev), ref_codes])
    snp_depth = torch.empty((P, k, 3), dtype=torch.int32, device=dev)
    snp_call = torch.empty((P, k, 3), dtype=torch.bool, device=dev)
    max_rescue = torch.empty(P, dtype=torch.int32, device=dev)
    del_depth = torch.empty((P, k), dtype=torch.int32, device=dev)
    del_call = torch.empty((P, k), dtype=torch.bool, device=dev)
    kernels.CALL_SCAN(pref, P, k, depth.contiguous(), avg.contiguous(), site.contiguous(),
                      table, T, snp_depth, snp_call, max_rescue, del_depth, del_call)
    return snp_depth, snp_call, max_rescue, del_depth, del_call


def call_scan_ref(ref_codes: torch.Tensor, table: torch.Tensor, k: int,
                  window_len: int) -> dict:
    """One reference row -> what the caller needs.

    ref_codes: [L] uint8 (A=0 C=1 G=2 T=3, >= 4 invalid), L >= k; table:
    the depth map's [T, 4] int32 table on the same device.  Returns the
    JAX function's dict: depth, avg, site [P]; snp_depth, snp_call [P, k,
    3]; max_rescue [P]; del_depth, del_call [P, k] (P = L - k + 1).  On a
    CUDA tensor: K1, K8, the glue, K9; on a CPU tensor: call_scan_plain."""
    if ref_codes.dtype != torch.uint8 or ref_codes.dim() != 1 or ref_codes.shape[0] < k or k < 1:
        raise ValueError(f"call scan takes [L] uint8 codes with L >= k >= 1, got "
                         f"{tuple(ref_codes.shape)} {ref_codes.dtype}, k={k}")
    if ref_codes.device.type == "cpu":
        return call_scan_plain(ref_codes, table, k, window_len)
    if ref_codes.device.type != "cuda":
        raise ValueError(f"no call-scan path for device {ref_codes.device}")
    depth = hashmap_get(table, positional_hashes(ref_codes, k))
    avg, site = window_average(depth, window_len)
    snp_depth, snp_call, max_rescue, del_depth, del_call = _call_scan_cuda(
        ref_codes, table, k, depth, avg, site)
    return dict(depth=depth, avg=avg, site=site, snp_depth=snp_depth, snp_call=snp_call,
                max_rescue=max_rescue, del_depth=del_depth, del_call=del_call)
