"""hpv16's sorted-panel probe: sorted hash rows -> per-read (best type,
its count, unique-group counts) against the sorted-key panel.

The fallback for a combined type + group panel whose bucket table would
pass the set-table cap (``commands/hpv16_cmd.build_tables``).  On a CUDA
tensor it is K10 (``csrc/set_probe.cu``, ``rkmh_sorted_probe``): K3's
kernel with the bucket probe replaced by a binary search of the sorted
keys.  On a CPU tensor it is ``sorted_probe_plain``, the plain port of
the JAX package's ``_hpv16_sorted_core`` after its sort
(``rkmh_tpu/classify/engine.py:829-862``: occurrence ranks, the
set-semantics query mask, ``sorted_panel_counts_masked`` and the type
argmax), which the kernel must match exactly.

Rows are [B, n] int64 hashes sorted in unsigned order (a full-width
bottom_s_sketch cut to the first n columns) with lens [B]: an element is
queried when i < len, h != SENTINEL and it starts a run of equal values.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.intersect import occ_ranks
from rkmh_tpu_torch.ops.lookup import sorted_panel_counts_masked
from rkmh_tpu_torch.ops.set_probe import SEGMENT, _best_type_and_groups
from rkmh_tpu_torch.ops.sketch import SENTINEL

# the plain version gathers [reads, n, Wm] mask words as int64; it goes
# through the batch in pieces of at most this many of them
_PLAIN_WORDS = 1 << 26


@dataclass
class SortedPanel:
    """The sorted-key panel on one device: ``keys`` [U] int64, the sorted
    distinct hashes with the sign bit flipped (ascending as signed
    values); ``masks`` [U, Wm] int32, bit r of a key's row set iff
    reference r holds it.  ``convert.sorted_panel_from_numpy`` makes it
    from ``ops/lookup.build_sorted_panel``'s arrays."""

    keys: torch.Tensor
    masks: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def mask_words(self) -> int:
        return self.masks.shape[1]

    @property
    def nbytes(self) -> int:
        return self.keys.numel() * 8 + self.masks.numel() * 4


def sorted_probe_plain(rows: torch.Tensor, lens: torch.Tensor, panel: SortedPanel,
                       num_types: int, num_uniq: int) -> torch.Tensor:
    """[B, n] sorted int64 rows + lens -> int64 [B, 2+U], in plain PyTorch."""
    B, n = rows.shape
    step = max(1, _PLAIN_WORDS // max(1, n * panel.mask_words))
    parts = []
    for r0 in range(0, B, step):
        full, ln = rows[r0 : r0 + step], lens[r0 : r0 + step]
        qmask = ((torch.arange(n, device=rows.device)[None, :] < ln[:, None])
                 & (full != SENTINEL) & (occ_ranks(full) == 0))  # set semantics
        parts.append(sorted_panel_counts_masked(full, qmask, panel.keys, panel.masks,
                                                num_types + num_uniq))
    counts = torch.cat(parts) if parts else torch.zeros(
        (0, num_types + num_uniq), dtype=torch.int32, device=rows.device)
    return _best_type_and_groups(counts, num_types)


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
        kernels.SORTED_PROBE(rows, rows.stride(0), lens, B, n, keys.contiguous(), keys.numel(),
                             masks.contiguous(), Wm, num_types, num_uniq, seg, counts, done, out)
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
