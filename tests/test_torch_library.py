"""The port's equiv.hpp library surface against rkmh-tpu's.

``rkmh_tpu_torch.classify.library`` and ``ops.intersect.intersection_counts``
against ``rkmh_tpu.classify.library`` and ``rkmh_tpu.ops.intersect``: the
scalar forms on ``tests/test_library.py``'s rows, then the batch forms on
random 0-padded rows made from a numpy seed, small values and values at and
above 2**63 (the port holds hashes as int64 bit patterns, so these are
negative there), against the JAX package's outputs and the scalar spec.
No tolerance: every output is an integer or a name and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.classify import library as jlib
from rkmh_tpu.ops.intersect import intersection_counts as jax_intersection_counts
from rkmh_tpu.ops.intersect import sort_hashes_padded as jax_sort_padded
from rkmh_tpu_torch import oracle
from rkmh_tpu_torch.classify import library as tlib
from rkmh_tpu_torch.ops import intersect
from rkmh_tpu_torch.ops.intersect import sort_hashes_padded

TOP = 1 << 63


def _t(a: np.ndarray) -> torch.Tensor:
    """uint64 numpy -> the port's int64 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64).copy())


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("mins,s", [([[5, 9, 30], [1, 9, 40], [2, 50]], 4),
                                    ([[5, 5], [9]], 2), ([[0, 7], [3]], 2),
                                    ([[TOP + 5, 3, 0], [TOP + 1, TOP + 5]], 3)])
def test_merge_scalar(mins, s):
    assert tlib.merge_sketches(mins, s) == jlib.merge_sketches(mins, s)


@pytest.mark.parametrize("counter_size", [None, 100])
def test_merge_with_counts_scalar(counter_size):
    for mins in ([[5, 9], [9, 105]], [[TOP + 2, 9], [9, TOP + 2, TOP + 102]]):
        assert (tlib.merge_sketches_with_counts(mins, 1, counter_size)
                == jlib.merge_sketches_with_counts(mins, 1, counter_size))


@pytest.mark.parametrize("max_samples", [2, 3])
def test_only_informative_kmers_scalar(max_samples):
    data = {"a": [1, 2, 3, 3], "b": [2, 3], "c": [3, 4, TOP + 1], "d": [TOP + 1]}
    assert (tlib.only_informative_kmers(data, max_samples)
            == jlib.only_informative_kmers(data, max_samples))


def test_classify_and_all_hash_compare_scalar():
    refs = {"r1": [1, 2, 3], "r2": [3, 4, 5, 6], "r0": [TOP + 3, TOP + 3]}
    for read in ([3, 4, 5], [99], [TOP + 3, TOP + 3, 1], [3, 3]):
        assert tlib.classify(read, refs) == jlib.classify(read, refs)
        pairs = sorted(refs.items())
        assert tlib.all_hash_compare(read, pairs) == jlib.all_hash_compare(read, pairs)
    assert tlib.all_hash_compare([3, 3], [("r", [3, 3, 3])]) == [2]
    assert oracle.intersection_size([1, 2, 2, TOP], [2, 2, 2, TOP]) == 3


def _rows(seed, shape, high):
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 60, size=shape).astype(np.uint64)
    if high:  # on both sides of 2**63
        rows += np.uint64(TOP - 30)
    rows[rng.random(shape) < 0.2] = 0  # invalid holes
    return rows


@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("s", [4, 25, 500])
def test_merge_batch(high, s):
    rows = _rows(11, (7, 40), high)
    want, n = jlib.merge_sketches_batch(jnp.asarray(rows), s)
    got, m = tlib.merge_sketches_batch(_t(rows), s)
    assert np.array_equal(_u(got), np.asarray(want)) and int(m) == int(n)
    lists = [[int(h) for h in r if h] for r in rows]
    assert _u(got)[: int(m)].tolist() == tlib.merge_sketches(lists, s)


@pytest.mark.parametrize("high", [False, True])
def test_merge_with_counts_batch(high):
    rows = _rows(12, (7, 40), high)
    want = jlib.merge_sketches_with_counts_batch(jnp.asarray(rows), 5)
    got = tlib.merge_sketches_with_counts_batch(_t(rows), 5)
    assert np.array_equal(_u(got[0]), np.asarray(want[0]))
    assert got[1].dtype == torch.int32 and np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("max_samples", [2, 4])
def test_informative_mask_batch(high, max_samples):
    rows = _rows(13, (7, 40), high)
    want = np.asarray(jlib.informative_mask_batch(jnp.asarray(rows), max_samples))
    got = tlib.informative_mask_batch(_t(rows), max_samples)
    assert np.array_equal(got.numpy(), want)
    named = {f"s{i}": [int(h) for h in r if h] for i, r in enumerate(rows)}
    spec = tlib.only_informative_kmers(named, max_samples)
    assert {f"s{i}": [int(h) for h, k in zip(r, got[i].tolist()) if k]
            for i, r in enumerate(rows)} == spec


@pytest.mark.parametrize("high", [False, True])
def test_compare_and_classify_batch(high):
    rows = _rows(14, (9, 40), high)
    ref_rows = _rows(15, (3, 30), high)
    rs, rl = sort_hashes_padded(_t(rows), _t(rows) != 0)
    fs, fl = sort_hashes_padded(_t(ref_rows), _t(ref_rows) != 0)
    jrs, jrl = jax_sort_padded(jnp.asarray(rows), jnp.asarray(rows) != 0)
    jfs, jfl = jax_sort_padded(jnp.asarray(ref_rows), jnp.asarray(ref_rows) != 0)
    want = np.asarray(jlib.all_hash_compare_batch(jrs, jrl, jfs, jfl))
    got = tlib.all_hash_compare_batch(rs, rl, fs, fl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    names = ["b", "a", "c"]
    assert (tlib.classify_batch(rs, rl, fs, fl, names)
            == jlib.classify_batch(jrs, jrl, jfs, jfl, names))
    ref_lists = [(n, [int(h) for h in r if h]) for n, r in zip(names, ref_rows)]
    for i, r in enumerate(rows):
        assert got[i].tolist() == tlib.all_hash_compare([int(h) for h in r if h], ref_lists)


def test_intersection_counts_in_chunks(monkeypatch):
    """Many references, taken a few at a time: the same counts as one step
    and as the JAX package (duplicates, read lengths shorter than the row)."""
    rng = np.random.default_rng(16)
    reads = np.sort(rng.integers(1, 40, size=(5, 30)).astype(np.uint64), axis=1)
    reads[:, -4:] = np.uint64(2**64 - 1)  # SENTINEL padding
    lens = np.array([26, 26, 10, 0, 26], np.int32)
    refs = np.sort(rng.integers(1, 40, size=(70, 20)).astype(np.uint64), axis=1)
    refs[::7] += np.uint64(TOP)
    refs = np.sort(refs, axis=1)
    want = np.asarray(jax_intersection_counts(jnp.asarray(reads), jnp.asarray(lens),
                                              jnp.asarray(refs)))
    whole = intersect.intersection_counts(_t(reads), torch.from_numpy(lens), _t(refs))
    monkeypatch.setattr(intersect, "_ref_chunk", lambda B, s: 8)
    chunked = intersect.intersection_counts(_t(reads), torch.from_numpy(lens), _t(refs))
    assert np.array_equal(whole.numpy(), want) and np.array_equal(chunked.numpy(), want)
    assert want[3].sum() == 0 and want.max() > 0
