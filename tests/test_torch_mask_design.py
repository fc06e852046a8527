"""The premise of the K7 (counter mask) kernel's design, held against
its plain version and the JAX package on the CPU at small sizes.

K7 (``counter_mask_kernel`` in csrc/counter.cu) splits the hashes into an
odd head element (a view whose address is 8 mod 16), 16-byte vectors of
two, one a thread, walked by the grid, and an odd last element; it loads
no count for hash 0.  A numpy model of that split must write every
element once, touch nothing past n, and equal ``counter_mask_plain`` and
the JAX ``counter_get`` + ``mask_by_frequency(_range)`` chain, at element
offsets 0-7, with hash 0 among the elements and with lo = 0.

Inputs are made from a seed with numpy.  Tolerance: none (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.ops.counter import counter_get as jax_counter_get
from rkmh_tpu.ops.sketch import mask_by_frequency, mask_by_frequency_range
from rkmh_tpu_torch.ops import counter

MASK_THREADS = 256  # csrc/counter.cu


def counter_mask_model(table: np.ndarray, hashes: np.ndarray, lo: int, hi: int,
                       in_offset: int, out_offset: int, blocks: int):
    """csrc/counter.cu's K7 on uint64 ``hashes`` that start ``in_offset``
    elements (8 bytes each) past a 16-byte boundary and an output that
    starts ``out_offset`` past one, with ``blocks`` blocks.  -> (out, times
    each element was written, elements whose count was loaded)."""
    n = hashes.size
    size = table.size
    out = np.full(n, 0xDEAD, dtype=np.uint64)
    writes = np.zeros(n, dtype=np.int64)
    loaded = np.zeros(n, dtype=bool)

    def read(i):
        assert 0 <= i < n, "read past the hashes"
        return int(hashes[i])

    def one(i, h, c):
        assert 0 <= i < n, "write past the output"
        out[i] = h if lo <= c <= hi else 0
        writes[i] += 1

    def count(i, h):
        if h == 0:
            return 0
        loaded[i] = True
        return int(table[h % size])

    head = 1 if in_offset % 2 else 0  # 8-byte elements: 16-byte aligned at even offsets
    head = min(head, n)
    nvec = (n - head) >> 1
    vec_out = (out_offset + head) % 2 == 0
    # block 0, threads 0 and 1: the head and the odd last element
    for t in range(2):
        i = (0 if head else n) if t == 0 else (n - 1 if (n - head) & 1 else n)
        if i < n:
            h = read(i)
            one(i, h, count(i, h))
    for b in range(blocks):
        for t in range(MASK_THREADS):
            for v in range(b * MASK_THREADS + t, nvec, blocks * MASK_THREADS):
                x = (read(head + 2 * v), read(head + 2 * v + 1))
                c = (count(head + 2 * v, x[0]), count(head + 2 * v + 1, x[1]))
                if vec_out:
                    assert (out_offset + head + 2 * v) % 2 == 0  # a 16-byte store
                one(head + 2 * v, x[0], c[0])
                one(head + 2 * v + 1, x[1], c[1])
    return out, writes, loaded


def _mask_inputs(seed, n, size=1009):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    h[rng.random(n) < 0.3] = 0  # padding zeros, as in an hpv16 -M batch
    h[1::3] = h[::3][: h[1::3].size]  # repeats
    table = np.zeros(size, dtype=np.int32)
    np.add.at(table, (h % np.uint64(size)).astype(np.int64), 1)
    table[0] = 3  # hash 0's slot holds a count in every window
    return table, h


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("n", [1, 3, 7, 8, 4097])
def test_counter_mask_model_splits_any_view(offset, n):
    table, h = _mask_inputs(offset * 10 + n, n)
    want_port = {}
    for lo, hi in ((2, counter.INT32_MAX), (0, 3), (0, 1)):  # -M, -I (lo = 0), a narrow -I
        for out_offset, blocks in ((0, 1), (offset, 3)):  # a fresh output; a shifted one
            got, writes, loaded = counter_mask_model(table, h, lo, hi, offset, out_offset,
                                                     blocks)
            assert (writes == 1).all()
            assert not loaded[h == 0].any() and loaded[h != 0].all()
            want = counter.counter_mask_plain(torch.from_numpy(table),
                                              torch.from_numpy(h.view(np.int64)), lo, hi)
            assert np.array_equal(got.view(np.int64), want.numpy())
            want_port[lo, hi] = got
        assert (want_port[lo, hi][h == 0] == 0).all()
    counts = jax_counter_get(jnp.asarray(table), jnp.asarray(h))
    assert np.array_equal(np.asarray(mask_by_frequency(jnp.asarray(h), counts, 2)),
                          want_port[2, counter.INT32_MAX])
    for lo, hi in ((0, 3), (0, 1)):
        assert np.array_equal(
            np.asarray(mask_by_frequency_range(jnp.asarray(h), counts, lo, hi)),
            want_port[lo, hi])
    # lo = 0 still zeroes every hash counted above hi
    over = (h != 0) & (table[(h % np.uint64(table.size)).astype(np.int64)] > 1)
    assert (want_port[0, 1][over] == 0).all()


def test_counter_mask_on_a_view_at_an_odd_offset_is_the_plain_mask():
    table, h = _mask_inputs(5, 301)
    t, x = torch.from_numpy(table), torch.from_numpy(h.view(np.int64))
    view = x[5:]  # storage offset 5: 8 mod 16 bytes past the allocation
    assert view.storage_offset() == 5 and view.is_contiguous()
    got = counter.counter_mask(t, view, 0, 2)
    assert torch.equal(got, counter.counter_mask_plain(t, x, 0, 2)[5:])
