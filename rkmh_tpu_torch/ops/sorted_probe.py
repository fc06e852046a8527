"""hpv16's sorted-panel probe: sorted hash rows -> per-read (best type,
its count, unique-group counts) against the sorted-key panel.

The fallback for a combined type + group panel whose bucket table would
pass the set-table cap (``commands/hpv16_cmd.build_tables``).  On a CUDA
tensor it is K10 (``csrc/set_probe.cu``, ``rkmh_sorted_probe``): K3's
kernel with the bucket probe replaced by a probe of the sorted keys
under a directory of their top bits.  On a CPU tensor it is
``sorted_probe_plain``, the plain port of the JAX package's
``_hpv16_sorted_core`` after its sort
(``rkmh_tpu/classify/engine.py:829-862``: occurrence ranks, the
set-semantics query mask, ``sorted_panel_counts_masked`` and the type
argmax), which the kernel must match exactly.  ``sorted_probe_plain_dir``
computes the same through the directory, as the kernel reads it.

Rows are [B, n] int64 hashes sorted in unsigned order (a full-width
bottom_s_sketch cut to the first n columns) with lens [B]: an element is
queried when i < len, h != SENTINEL and it starts a run of equal values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.hashmap import bucket_bits
from rkmh_tpu_torch.ops.intersect import occ_ranks
from rkmh_tpu_torch.ops.lookup import M32, sorted_panel_counts_masked
from rkmh_tpu_torch.ops.popcount import vertical_popcounts
from rkmh_tpu_torch.ops.set_probe import SEGMENT, _best_type_and_groups
from rkmh_tpu_torch.ops.sketch import INT64_MIN, SENTINEL

# the plain version gathers [reads, n, Wm] mask words as int64; it goes
# through the batch in pieces of at most this many of them
_PLAIN_WORDS = 1 << 26


@dataclass
class SortedPanel:
    """The sorted-key panel on one device: ``keys`` [U] int64, the sorted
    distinct hashes with the sign bit flipped (ascending as signed
    values); ``masks`` [U, Wm] int32, bit r of a key's row set iff
    reference r holds it; ``dir`` [2**bits + 1] int32, the directory over
    the keys' top ``bits`` bits (unsigned): bucket b's keys are
    ``keys[dir[b]:dir[b+1]]``.  ``convert.sorted_panel_from_numpy`` makes
    it from ``ops/lookup.build_sorted_panel``'s arrays, the keys and the
    directory in one buffer."""

    keys: torch.Tensor
    masks: torch.Tensor
    dir: torch.Tensor | None = None
    bits: int = 0

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def mask_words(self) -> int:
        return self.masks.shape[1]

    @property
    def directory_bytes(self) -> int:
        return 0 if self.dir is None else self.dir.numel() * 4

    @property
    def nbytes(self) -> int:
        return self.keys.numel() * 8 + self.masks.numel() * 4 + self.directory_bytes


def build_directory(keys_u64: np.ndarray) -> tuple[np.ndarray, int]:
    """Sorted distinct uint64 keys [U] -> (int32 [2**D + 1] directory,
    D): bucket b (the keys whose top D bits are b) holds entries
    [dir[b], dir[b+1]).  D = max(8, bit_length(U) - 2), so a bucket holds
    2 to 4 keys on average (``ops/hashmap.bucket_bits``)."""
    keys = np.asarray(keys_u64, dtype=np.uint64)
    if keys.size >= 2**31:
        raise ValueError(f"a sorted panel holds fewer than 2**31 keys, got {keys.size}")
    bits = bucket_bits(keys.size)
    d = np.zeros((1 << bits) + 1, dtype=np.int32)
    np.cumsum(np.bincount((keys >> np.uint64(64 - bits)).astype(np.int64),
                          minlength=1 << bits), out=d[1:])
    return d, bits


def directory_positions(panel: SortedPanel, q: torch.Tensor) -> torch.Tensor:
    """The index of each flipped query in ``panel.keys`` where it is
    there (any index of its bucket where not), found as the kernel finds
    it: the bucket from the directory, then a lower-bound search inside
    [dir[b], dir[b+1])."""
    bits = panel.bits
    b = ((q ^ INT64_MIN) >> (64 - bits)) & ((1 << bits) - 1)  # the unsigned top bits
    lo = panel.dir[b].to(torch.int64)
    hi = panel.dir[b + 1].to(torch.int64)
    last = max(0, panel.keys.numel() - 1)
    while True:
        act = lo < hi
        if not bool(act.any()):
            break
        mid = (lo + hi) >> 1
        less = panel.keys[mid.clamp(max=last)] < q
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    return lo.clamp(max=last)


def sorted_probe_plain(rows: torch.Tensor, lens: torch.Tensor, panel: SortedPanel,
                       num_types: int, num_uniq: int) -> torch.Tensor:
    """[B, n] sorted int64 rows + lens -> int64 [B, 2+U], in plain PyTorch."""
    return _plain(rows, lens, panel, num_types, num_uniq, directory=False)


def sorted_probe_plain_dir(rows: torch.Tensor, lens: torch.Tensor, panel: SortedPanel,
                           num_types: int, num_uniq: int) -> torch.Tensor:
    """``sorted_probe_plain`` through the panel's directory
    (``directory_positions``) in place of ``torch.searchsorted`` over all
    keys: the layout the kernel reads, in plain PyTorch."""
    _check_directory(panel)
    return _plain(rows, lens, panel, num_types, num_uniq, directory=True)


def _plain(rows, lens, panel, num_types, num_uniq, directory: bool):
    B, n = rows.shape
    R = num_types + num_uniq
    step = max(1, _PLAIN_WORDS // max(1, n * panel.mask_words))
    parts = []
    for r0 in range(0, B, step):
        full, ln = rows[r0 : r0 + step], lens[r0 : r0 + step]
        qmask = ((torch.arange(n, device=rows.device)[None, :] < ln[:, None])
                 & (full != SENTINEL) & (occ_ranks(full) == 0))  # set semantics
        if not directory:
            parts.append(sorted_panel_counts_masked(full, qmask, panel.keys, panel.masks, R))
            continue
        q = full ^ INT64_MIN
        pos = directory_positions(panel, q.reshape(-1)).reshape(q.shape)
        hit = (panel.keys[pos] == q) & qmask
        mw = torch.where(hit[..., None], panel.masks[pos].to(torch.int64) & M32,
                         torch.zeros((), dtype=torch.int64, device=rows.device))
        parts.append(torch.cat([vertical_popcounts(mw[..., w], min(32, R - 32 * w))
                                for w in range((R + 31) // 32)], dim=-1))
    counts = torch.cat(parts) if parts else torch.zeros(
        (0, R), dtype=torch.int32, device=rows.device)
    return _best_type_and_groups(counts, num_types)


def _check_directory(panel: SortedPanel) -> None:
    d, bits = panel.dir, panel.bits
    if d is None:
        raise ValueError("the sorted panel has no directory: make it with "
                         "convert.sorted_panel_from_numpy")
    if not 1 <= bits <= 31 or d.dtype != torch.int32 or d.shape != ((1 << bits) + 1,):
        raise ValueError(f"a sorted panel's directory is int32 [2**bits + 1], got "
                         f"{tuple(d.shape)} {d.dtype} with bits={bits}")
    if d.device != panel.keys.device:
        raise ValueError("the sorted panel's directory lies on another device than its keys")


def _sorted_probe_cuda(rows, lens, panel, num_types, num_uniq, seg: int = SEGMENT):
    if rows.dtype != torch.int64 or rows.dim() != 2:
        raise ValueError(f"sorted probe takes [B, n] int64 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if not isinstance(panel, SortedPanel):
        raise ValueError("sorted probe takes a SortedPanel")
    keys, masks = panel.keys, panel.masks
    if keys.device != rows.device or masks.device != rows.device:
        raise ValueError("the sorted panel lies on another device than the rows")
    if keys.dtype != torch.int64 or keys.dim() != 1 or not 1 <= keys.numel() < 2**31:
        raise ValueError(f"sorted probe takes 1 to 2**31 - 1 int64 keys, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if masks.dtype != torch.int32 or masks.dim() != 2 or masks.shape[0] != keys.numel():
        raise ValueError(f"sorted probe takes int32 [U, Wm] masks for U = {keys.numel()} "
                         f"keys, got {tuple(masks.shape)} {masks.dtype}")
    _check_directory(panel)
    # the kernel reads two keys a 16-byte load and a directory pair an 8-byte one
    if not (keys.is_contiguous() and keys.data_ptr() % 16 == 0 and panel.dir.is_contiguous()
            and panel.dir.data_ptr() % 8 == 0):
        raise ValueError("sorted probe takes contiguous keys on a 16-byte boundary and a "
                         "contiguous directory on an 8-byte one")
    Wm = masks.shape[1]
    if num_types < 1 or num_uniq < 0:
        raise ValueError(f"sorted probe needs >= 1 type and >= 0 groups, got "
                         f"{num_types} and {num_uniq}")
    if num_types + num_uniq > 32 * Wm:
        raise ValueError(f"{num_types} + {num_uniq} references do not fit {Wm} mask words")
    B, n = rows.shape
    if lens.shape != (B,) or lens.device != rows.device:
        raise ValueError("lens must be [B] on the rows' device")
    if n and rows.stride(1) != 1:
        rows = rows.contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty((B, 2 + num_uniq), dtype=torch.int64, device=rows.device)
    if B:
        counts = done = None
        if n > seg:  # some read may span several blocks
            scratch = torch.zeros(B * (32 * Wm + 1), dtype=torch.int32, device=rows.device)
            counts, done = scratch[B:], scratch[:B]
        kernels.SORTED_PROBE(rows, rows.stride(0), lens, B, n, keys, keys.numel(), panel.dir,
                             panel.bits, masks.contiguous(), Wm, num_types, num_uniq, seg,
                             counts, done, out)
    return out


def sorted_probe(rows: torch.Tensor, lens: torch.Tensor, panel: SortedPanel, num_types: int,
                 num_uniq: int) -> torch.Tensor:
    """[B, n] sorted int64 rows + lens -> int64 [B, 2+U]: K10 on a CUDA
    tensor, ``sorted_probe_plain`` on a CPU tensor."""
    if rows.device.type == "cuda":
        return _sorted_probe_cuda(rows, lens, panel, num_types, num_uniq)
    if rows.device.type != "cpu":
        raise ValueError(f"no sorted-probe path for device {rows.device}")
    return sorted_probe_plain(rows, lens, panel, num_types, num_uniq)
