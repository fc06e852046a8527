"""Bottom-s MinHash sketches of window-hash rows.

Counterpart of ``rkmh_tpu/ops/sketch.py`` (``SENTINEL`` :20,
``bottom_s_sketch`` :46): sort each row ascending as uint64, with the
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
