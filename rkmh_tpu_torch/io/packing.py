"""Sequences -> [B, L] uint8 code arrays (A=0 C=1 G=2 T=3, invalid/pad >= 4).

Copied from ``rkmh_tpu/io/packing.py:9-131`` (numpy only), for the reason
given in ``io/fastx.py``: ``encode_seqs``, ``bucket_length`` and
``length_buckets`` (which applies ``grid_length``'s grid inline, so that
helper is not copied).  The 2-bit ``pack_codes4`` wire format was a trick
for a remote accelerator link and is not ported.
"""

from __future__ import annotations

import numpy as np

PAD_CODE = np.uint8(255)

# byte -> 2-bit code; case-insensitive; everything non-ACGT is invalid (4)
CODE_LUT = np.full(256, 4, dtype=np.uint8)
for i, base in enumerate(b"ACGT"):
    CODE_LUT[base] = i
    CODE_LUT[base + 32] = i  # lowercase


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_length(max_len: int, granularity: int = 128) -> int:
    """Static padded length for a batch: next multiple of `granularity`."""
    return max(round_up(max_len, granularity), granularity)


def encode_seqs(seqs: list[bytes], pad_to: int | None = None, granularity: int = 128):
    """Pack byte strings into ([B, L] uint8 codes, [B] int32 lengths).

    Padding positions get PAD_CODE (invalid), so padded windows hash to the
    0 sentinel and never enter a sketch.
    """
    B = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    L = pad_to if pad_to is not None else bucket_length(int(lens.max(initial=0)), granularity)
    codes = np.full((B, L), PAD_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = CODE_LUT[np.frombuffer(s, dtype=np.uint8)]
    return codes, lens


_GRID_FINE_CAP = 512
_GRID_FINE_STEP = 32


def length_buckets(lengths, max_buckets: int = 8):
    """Assign each read to a padded-length bucket on a grid of multiples of
    32 up to 512 and of 128 beyond (a 150 bp read pads to 160, not 256);
    returns sorted unique bucket lengths and per-read bucket index.
    Bounds padding waste for mixed-length inputs."""
    lengths = np.asarray(lengths)
    l = np.maximum(lengths, _GRID_FINE_STEP)
    fine = ((l + _GRID_FINE_STEP - 1) // _GRID_FINE_STEP) * _GRID_FINE_STEP
    coarse = ((l + 127) // 128) * 128
    raw = np.where(l <= _GRID_FINE_CAP, fine, coarse)
    uniq = np.unique(raw)
    if len(uniq) > max_buckets:
        # merge to at most max_buckets by quantile cut points
        qs = np.quantile(uniq, np.linspace(0, 1, max_buckets + 1)[1:], method="higher")
        uniq = np.unique(qs)
    idx = np.searchsorted(uniq, raw, side="left")
    idx = np.minimum(idx, len(uniq) - 1)
    # ensure each read's bucket is >= its length
    while np.any(uniq[idx] < lengths):
        idx = np.where(uniq[idx] < lengths, np.minimum(idx + 1, len(uniq) - 1), idx)
    return uniq, idx
