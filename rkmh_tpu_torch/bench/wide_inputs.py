"""Seeded inputs for the panel probe past 8,192 references (K11).

``straddling_panel(R)`` makes R reference sketches and read rows whose
counts put ties and maxima on both sides of reference 8,192, the first
reference past K2's counters (``ops/probe.MAX_REFS``):

* read 0 shares set A (10 values) with references 100 and R - 1: equal
  maxima on both sides, the first max below;
* read 1 shares set B (12 values) whole with reference 8,192 and 11 of
  them with 8,191: the first max after 8,192, the previous best one less;
* read 2 shares set C (8 values) with references 8,190 and 8,192: a tie
  straddling 8,192;
* read 3 shares set D (8 values) with 8,189 and R - 1;
* read 4 holds value X 40 times among others and read 5 nothing but X;
  reference 8,191 holds X three times and reference 50 twice, so ranks
  0..2 of X hit (duplicate-heavy rows);
* the other reads draw from every value, a tenth of them 0 (invalid).

The other references hold 2 to 6 values of a filler pool.  A third of all
values have a high word >= 2**31.  Used by ``tests/test_torch_wide_probe.py``,
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

SENTINEL = -1
PAST = 8192  # the first reference past K2's counters


def straddling_panel(R: int, seed: int = 0, n_reads: int = 64, width: int = 64):
    """-> (ref_sk [R, t] int64 sorted as uint64 and SENTINEL-padded,
    ref_lens [R] int32, raw read rows [n_reads, width] int64, 0 = invalid,
    ref_set_lens [R] int32 for the filter epilogue).  Needs R > PAST and
    n_reads >= 8."""
    if R <= PAST or n_reads < 8:
        raise ValueError(f"straddling_panel needs R > {PAST} and >= 8 reads")
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=4096, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    A, B, C, D, X = pool[0:10], pool[10:22], pool[22:30], pool[30:38], pool[40]
    filler = pool[64:]
    sets = {r: list(rng.choice(filler, int(rng.integers(2, 7)))) for r in range(R)}
    for r, vals in ((100, A), (R - 1, A), (PAST, B), (PAST - 1, B[:11]), (PAST - 2, C),
                    (PAST, C), (PAST - 3, D), (R - 1, D), (PAST - 1, [X] * 3), (50, [X] * 2)):
        sets[r] = sets[r] + list(vals)
    t = max(len(v) for v in sets.values())
    ref_sk = np.full((R, t), SENTINEL, dtype=np.int64)
    ref_lens = np.zeros(R, dtype=np.int32)
    for r, vals in sets.items():
        row = np.sort(np.asarray(vals, dtype=np.int64).view(np.uint64)).view(np.int64)
        ref_sk[r, : len(row)] = row
        ref_lens[r] = len(row)
    reads = rng.choice(pool[:256], size=(n_reads, width))
    reads[rng.random(reads.shape) < 0.1] = 0
    for i, vals in enumerate((A, B, C, D)):
        reads[i] = 0
        reads[i, : len(vals)] = vals
    reads[4, :40] = X
    reads[5] = X
    perm = np.argsort(rng.random(reads.shape), axis=1)
    reads = np.take_along_axis(reads, perm, 1)
    return ref_sk, ref_lens, reads, rng.integers(0, 80, R).astype(np.int32)
