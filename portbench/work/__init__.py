"""The least bytes that a job's device work must move, counted from the
function the job computes and never from a layout of the program.

Each count is a floor on the traffic to the card's memory: every read base
at 2 bits; every distinct reference entry that the job's hashes find, at
its 8-byte hash and one membership bit for each column of the panel; each
counter slot touched, at 4 bytes, once; each output value, at 4 bytes,
once.  Over the summed time of every kernel of the window, at the H100
SXM's 3.35 TB/s, this gives a share of the roofline that cannot pass
100%, and that a later change to the program's kernels, batching or
layout leaves as it is.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, HBM3, the data sheet's rate


def base_bytes(bases: int) -> int:
    """Bases at 2 bits, rounded up."""
    return (2 * bases + 7) // 8


def entry_bytes(entries: int, columns: int) -> int:
    """Distinct entries found: an 8-byte hash and a membership bit a column."""
    return entries * (8 + (columns + 7) // 8)


def stream_bytes(bases: int, entries: int, refs: int, reads: int, slots: int) -> int:
    """stream / classify: the read bases, the panel entries found, the -M
    counter's slots touched, and a best reference and shared count a read."""
    return base_bytes(bases) + entry_bytes(entries, refs) + 4 * slots + 8 * reads


def hpv16_bytes(bases: int, entries: int, columns: int, reads: int, groups: int) -> int:
    """hpv16: the read bases, the set-table entries found over the type and
    group columns, and a best type, its count and each group's count a read."""
    return base_bytes(bases) + entry_bytes(entries, columns) + 4 * (2 + groups) * reads


def call_bytes(read_bases: int, ref_bases: int, keys: int, positions: int) -> int:
    """call: the read and reference bases, the depth map's distinct keys
    that the reference windows and the rescue scan's mutated k-mers find
    (an 8-byte key and a 4-byte count), and a depth and window average a
    position."""
    return base_bytes(read_bases) + base_bytes(ref_bases) + 12 * keys + 8 * positions


def roofline_pct(nbytes: float, kernel_s: float) -> float | None:
    """100 x the least time of ``nbytes`` over the kernels' summed time."""
    if kernel_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / kernel_s
