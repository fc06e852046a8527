"""Per-bit counts of mask words over an axis.

Counterpart of ``rkmh_tpu/ops/popcount.py::vertical_popcounts`` (:58) and
equal to it: out[..., r] is the number of words along the last axis with
bit r set.  The JAX version sums bit planes with a ripple-carry adder tree
to save vector operations on a TPU; this plain version counts one bit
position at a time.
"""

from __future__ import annotations

import torch


def vertical_popcounts(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """x [..., W] integer words (uint32 bit patterns) -> [..., nbits] int32,
    nbits >= 1."""
    return torch.stack(
        [((x >> r) & 1).sum(dim=-1, dtype=torch.int32) for r in range(nbits)], dim=-1)
