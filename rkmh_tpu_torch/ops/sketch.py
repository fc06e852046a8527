"""Bottom-s MinHash sketches of window-hash rows, and depth masks.

Counterpart of ``rkmh_tpu/ops/sketch.py`` (``SENTINEL`` :20,
``bottom_s_sketch`` :46, ``mask_by_frequency`` :64,
``mask_by_frequency_range`` :73): sort each row ascending as uint64, with the
invalid hash 0 sent to SENTINEL so it sorts last, and keep the first
min(s, W) columns.  Hashes are int64 bit patterns, so the unsigned sort is
a signed ``torch.sort`` of ``x ^ INT64_MIN``, flipped back afterwards.
"""

from __future__ import annotations

import torch

SENTINEL = -1  # 0xFFFFFFFFFFFFFFFF as int64
INT64_MIN = -(1 << 63)


def bottom_s_sketch(hashes: torch.Tensor, sketch_size: int):
    """[.., W] int64 window hashes -> ([.., min(s, W)] sorted sketch,
    [..] int32 count of real entries).  Zeros are excluded; short rows are
    SENTINEL-padded."""
    x = torch.where(hashes == 0, torch.full_like(hashes, SENTINEL), hashes)
    x = torch.sort(x ^ INT64_MIN, dim=-1).values ^ INT64_MIN  # unsigned order
    sk = x[..., : min(sketch_size, x.shape[-1])]
    lens = (sk != SENTINEL).sum(dim=-1, dtype=torch.int32)
    return sk, lens


def mask_by_frequency(hashes: torch.Tensor, counts: torch.Tensor, min_occ: int) -> torch.Tensor:
    """Hashes whose counted depth is >= min_occ, 0 elsewhere (stream and
    hpv16 -M, rkmh.cpp:916, 2663)."""
    return torch.where(counts >= min_occ, hashes, torch.zeros_like(hashes))


def mask_by_frequency_range(hashes: torch.Tensor, counts: torch.Tensor, min_occ: int,
                            max_occ: int) -> torch.Tensor:
    """Hashes whose count lies in [min_occ, max_occ], 0 elsewhere (-I keeps
    (0, max_samples), rkmh.cpp:835-836)."""
    keep = (counts >= min_occ) & (counts <= max_occ)
    return torch.where(keep, hashes, torch.zeros_like(hashes))
