"""Synthetic inputs of K13, the set-table fill (``csrc/set_table.cu``), at
the geometries its tiles meet.

The kernel stages a tile of whole bucket rows in shared memory, about
8,192 lanes of rows S * (3 + Wm) lanes wide (a multiple of 4 rows where
four fit), and cuts a row wider than that into windows.  ``GEOMETRIES``
crosses the slot widths S = 2, 4, 8 and 12 (the narrow and compact
policies' widths) with Wm = 1, 7 and 64 mask words (32, 196 and 2,048
references: a tp shard, the 182-type hpv16 panel, phase 40b's panel), at
1,029 buckets: an odd count, so no geometry's tile divides it and every
table ends in a partial tile, and more than the 1,024 rows of the
narrowest tile.  ``WIDE`` is a row of 8,436 lanes (S = 12, Wm = 700),
two windows a row.  ``fill_case`` makes a case's entries from a seed:
sorted by (bucket, lo, occ), one bucket holding S + 2 of them (a rank
past S), one pair of equal (lo, occ) in a bucket (a collision), a few
left out (bucket nb), ``idx`` a permutation of the mask rows.  The CPU
tests hold ``set_table_fill_plain`` to the JAX chain on them, the card
tests and ``chip_smoke.py`` phase 40 K13 to ``set_table_fill_plain``.
"""

from __future__ import annotations

import numpy as np

NB = 1029  # buckets: odd, past the narrowest tile's 1,024 rows
GEOMETRIES = [(S, Wm) for S in (2, 4, 8, 12) for Wm in (1, 7, 64)]
WIDE = (12, 700)  # 8,436 lanes a row: two windows of a tile


def fill_case(S: int, Wm: int, nb: int = NB, n: int | None = None, seed: int = 0,
              crowd: bool = True, left_out: int = 5):
    """-> (bucket, lo, occ, hi, idx [n] int32, masks [max(n, 1), Wm] int32),
    numpy, sorted as K13 takes them; n defaults to 2 nb entries (the tables'
    density, ~2 of S slots a bucket at S = 2 and fewer at wider S), and at
    least 4 S.
    ``crowd``: buckets drawn at random, bucket 1 holding S + 2 entries and
    bucket 2 two of equal (lo, occ); else at most S entries a bucket (a
    table that fits).  ``left_out`` entries go to bucket nb."""
    rng = np.random.default_rng([seed, S, Wm, nb])
    n = max(2 * nb, 4 * S) if n is None else n
    # uncrowded: at most S entries a bucket (n <= S nb)
    b = rng.integers(0, nb, n) if crowd else rng.choice(np.repeat(np.arange(nb), S), n,
                                                        replace=False)
    if crowd and n >= S + 5 and nb > 2:
        b[: S + 2] = 1
        b[S + 2: S + 4] = 2
    if left_out:
        b[-min(left_out, n):] = nb
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    occ = rng.integers(0, 3, n).astype(np.uint32)
    if crowd and n >= S + 5 and nb > 2:
        lo[S + 3], occ[S + 3] = lo[S + 2], occ[S + 2]
    order = np.lexsort((occ, lo, b))
    b, lo, occ = b[order].astype(np.int32), lo[order], occ[order]
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    idx = rng.permutation(n).astype(np.int32)
    masks = rng.integers(0, 2**32, (max(n, 1), Wm), dtype=np.uint64).astype(np.uint32)
    return (b, lo.view(np.int32), occ.view(np.int32), hi.view(np.int32), idx,
            masks.view(np.int32))
