"""rkmh_tpu_torch panel table, ranks, sketches and probe vs the JAX package.

Inputs are made from a seed with numpy.  Sketch values are drawn from a
shared pool, so rows hold duplicates and references share hashes; with
R = 40 the second mask word carries bits 32..39 and the first word bit 31,
and half of all hashes have a high word >= 2**31, so the uint32 bit
patterns that are negative as int32 are exercised.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from rkmh_tpu.ops import intersect as jintersect
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu.ops.popcount import vertical_popcounts as jax_popcounts
from rkmh_tpu.ops.sketch import bottom_s_sketch as jax_sketch
from rkmh_tpu_torch.ops import lookup
from rkmh_tpu_torch.ops.intersect import occ_ranks, prefix_eq_ranks
from rkmh_tpu_torch.ops.popcount import vertical_popcounts
from rkmh_tpu_torch.ops.probe import _panel_probe_cuda, panel_probe, panel_probe_plain
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sketches(rng, pool, n_rows, width, min_len=0):
    """Sorted SENTINEL-padded rows of values drawn with replacement."""
    sk = np.full((n_rows, width), SENT, dtype=np.uint64)
    lens = rng.integers(min_len, width + 1, n_rows).astype(np.int32)
    for r in range(n_rows):
        sk[r, : lens[r]] = np.sort(rng.choice(pool, size=lens[r]))
    return sk, lens


def _panel(seed, R=40, t=48):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**64 - 1, size=120, dtype=np.uint64)
    ref_sk, ref_lens = _sketches(rng, pool, R, t, min_len=t // 2)
    # read values: mostly panel values, some strangers
    read_pool = np.concatenate([pool, rng.integers(1, 2**64 - 1, 40, dtype=np.uint64)])
    read_sk, read_lens = _sketches(rng, read_pool, 24, 32)
    return ref_sk, ref_lens, read_sk, read_lens


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)


@pytest.mark.parametrize("R", [5, 40])
def test_host_builder_gives_identical_table(R):
    ref_sk, ref_lens, _, _ = _panel(R, R=R)
    want = jlookup.build_panel_table(ref_sk, ref_lens)
    got = lookup.build_panel_table(ref_sk.view(np.int64), ref_lens)
    assert got.num_refs == want.num_refs and got.mask_words == want.mask_words
    assert got.table.dtype == want.table.dtype
    assert np.array_equal(got.table, want.table)


def test_builder_handles_an_empty_panel():
    sk = np.full((3, 4), SENT, dtype=np.uint64)
    want = jlookup.build_panel_table(sk, np.zeros(3, np.int32))
    got = lookup.build_panel_table(sk, np.zeros(3, np.int32))
    assert np.array_equal(got.table, want.table)


def test_bucket_indices_match_jax():
    rng = np.random.default_rng(1)
    lo, hi = (rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32) for _ in "ab")
    occ = rng.integers(0, 5, 500).astype(np.uint32)
    for nb in (1, 2, 1024, 1 << 20):
        want = np.asarray(jlookup.bucket_indices(lo, hi, occ, nb))
        got = lookup.bucket_indices(*(torch.from_numpy(a.astype(np.int64)) for a in (lo, hi, occ)), nb)
        assert np.array_equal(got.numpy(), want), nb


def test_popcounts_match_jax():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**32, size=(6, 37), dtype=np.uint64).astype(np.uint32)
    assert (words >= 2**31).any()
    for nbits in (32, 8):
        want = np.asarray(jax_popcounts(words, nbits))
        got = vertical_popcounts(torch.from_numpy(words.view(np.int32)), nbits)
        assert np.array_equal(got.numpy(), want)


def test_sketch_matches_jax():
    rng = np.random.default_rng(4)
    h = rng.integers(0, 2**64, size=(10, 60), dtype=np.uint64)
    h[rng.random(h.shape) < 0.2] = 0
    h[:, :5] = h[:, 5:10]  # duplicates
    assert (h >= 2**63).any()
    for s in (20, 60, 100):
        want_sk, want_len = (np.asarray(a) for a in jax_sketch(h, s))
        got_sk, got_len = bottom_s_sketch(_t(h), s)
        assert np.array_equal(got_sk.numpy().view(np.uint64), want_sk)
        assert np.array_equal(got_len.numpy(), want_len)


def test_rank_paths_agree():
    rng = np.random.default_rng(5)
    h = rng.integers(1, 6, size=(12, 40)).astype(np.int64)  # many repeats
    ranks_unsorted = prefix_eq_ranks(torch.from_numpy(h))
    order = np.argsort(h, axis=-1, kind="stable")
    ranks_sorted = occ_ranks(torch.from_numpy(np.take_along_axis(h, order, -1)))
    # the same (value, rank) pairs, whatever the order
    back = np.empty_like(h)
    np.put_along_axis(back, order, ranks_sorted.numpy(), -1)
    assert np.array_equal(back, ranks_unsorted.numpy())
    want = np.asarray(jintersect.occ_ranks(np.sort(h, -1).astype(np.uint64)))
    assert np.array_equal(occ_ranks(torch.from_numpy(np.sort(h, -1))).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_counts_match_jax(seed):
    ref_sk, ref_lens, read_sk, read_lens = _panel(10 + seed)
    pt = jlookup.build_panel_table(ref_sk, ref_lens)
    S = lookup.table_slots(pt.table.shape[1], pt.num_refs)
    assert (pt.table[:, 3 * S:] >= 2**31).any()  # mask words with bit 31 set
    assert ((read_sk >> np.uint64(32)) >= 2**31).any()
    want = np.asarray(jlookup.lookup_intersection_counts(
        read_sk, read_lens, (pt.table,), pt.num_refs))
    ref = np.asarray(jintersect.intersection_counts(read_sk, read_lens, ref_sk, ref_lens))
    assert np.array_equal(want, ref)
    got = lookup.lookup_intersection_counts(
        _t(read_sk), _t(read_lens), _t(pt.table.view(np.int32)), pt.num_refs)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.max() > 1  # the panel really matches


def test_probe_row_modes_agree():
    ref_sk, ref_lens, read_sk, read_lens = _panel(20)
    table = _t(jlookup.build_panel_table(ref_sk, ref_lens).table.view(np.int32))
    rng = np.random.default_rng(20)
    # raw rows: the sketch values in a random order, zeros for the padding
    raw = np.where(read_sk == SENT, np.uint64(0), read_sk)
    raw = np.take_along_axis(raw, rng.permuted(np.tile(np.arange(32), (24, 1)), axis=1), 1)
    for md, mm in ((0, -1), (2, 5), (0, 40)):
        a = panel_probe(_t(raw), None, table, 40, md, mm)
        b = panel_probe(_t(read_sk), _t(read_lens), table, 40, md, mm)
        assert torch.equal(a, b)
        assert torch.equal(a, panel_probe_plain(_t(raw), None, table, 40, md, mm))


def test_probe_kernel_wrapper_rejects_what_it_cannot_hold():
    table = torch.zeros((4, 4 * (3 + 282)), dtype=torch.int32)
    with pytest.raises(ValueError, match="counters"):
        _panel_probe_cuda(torch.zeros((2, 8), dtype=torch.int64), None, table, 9000, 0, -1)
    with pytest.raises(ValueError, match="power of two"):
        _panel_probe_cuda(torch.zeros((2, 8), dtype=torch.int64), None,
                          torch.zeros((3, 20), dtype=torch.int32), 40, 0, -1)
