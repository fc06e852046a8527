"""The -M/-I k-mer counter, the filter epilogue and their engine steps vs
the JAX package, bit for bit.

``ops/counter`` (slots, the table after adds, the fused get-and-mask)
against ``rkmh_tpu/ops/counter.HashCounter`` at decimal and power-of-two
sizes small enough to force collisions, with hashes >= 2**63 and hash-0
windows; the depth masks, ``sort_hashes_padded`` and ``distinct_hash_mask``;
``argmax_filter`` on tied, all-zero and empty rows; the filter probe in
both row modes against ``filter_sketches_table_packed``; the depth-filtered
and informative sketches on a counter the JAX package built, carried over
by ``convert.counter_from_numpy``.  Inputs are made from a seed with
numpy; the port runs its plain path on the CPU.  Tolerance: none, every
output is an integer and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.classify import engine as jengine
from rkmh_tpu.ops import counter as jcounter
from rkmh_tpu.ops import intersect as jintersect
from rkmh_tpu.ops import sketch as jsketch
from rkmh_tpu.ops.lookup import build_panel_table as jax_build_table
from rkmh_tpu.utils import to_host
from rkmh_tpu_torch import convert, synth
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import PyPacked, build_ref_panel
from rkmh_tpu_torch.io.fastx import SeqRecord
from rkmh_tpu_torch.io.packing import CODE_LUT
from rkmh_tpu_torch.ops import counter, intersect, sketch
from rkmh_tpu_torch.ops.probe import (
    _panel_probe_filter_cuda,
    pack_filter_result,
    panel_probe_filter,
)

CPU = torch.device("cpu")
# decimal sizes (rkmh's 2e8 and 1e7, a prime that forces collisions) and
# powers of two (a mask); 1 sends every hash to slot 0
SIZES = [200_000_000, 10_000_000, 1009, 2**27, 4096, 1]


def _hashes(seed, shape=(40, 149)):
    """uint64 hashes, a third >= 2**63, ~5% zeros, repeated values; a mask."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64)
    h[rng.random(shape) < 0.05] = 0
    h[:, 1::4] = h[:, ::4][:, : h[:, 1::4].shape[1]]
    assert (h >= 2**63).mean() > 0.3
    return h, rng.random(shape) < 0.8


def _t(h_u64):
    return torch.from_numpy(h_u64.view(np.int64))


@pytest.mark.parametrize("size", SIZES)
def test_slots_match_jax(size):
    h, _ = _hashes(size % 997)
    h[0, :4] = (0, 2**63, 2**64 - 1, 2**64 - 2)
    want = np.asarray(jcounter._slots(jnp.asarray(h), size))
    got = counter.slots(_t(h), size)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(got.numpy(), (h % np.uint64(size)).astype(np.int64))


@pytest.mark.parametrize("size", [1009, 4096, 10_000_000])
def test_counter_table_matches_jax(size):
    h, mask = _hashes(size)
    jc = jcounter.HashCounter(size).add(jnp.asarray(h), jnp.asarray(mask))
    jc.add(jnp.asarray(h[:5]))  # no mask: every element
    hc = counter.HashCounter(size, "cpu").add(_t(h), torch.from_numpy(mask)).add(_t(h[:5]))
    assert hc.table.shape == (size,) and hc.table.dtype == torch.int32
    assert np.array_equal(hc.table.numpy(), jc.to_numpy())
    assert hc.table[0] >= int((mask & (h == 0)).sum())  # hash 0 counts in slot 0
    if size == 1009:
        assert hc.table.max() > 2  # collisions


@pytest.mark.parametrize("size", [1009, 4096])
@pytest.mark.parametrize("lo,hi", [(2, counter.INT32_MAX), (0, 3), (3, 5), (-7, 2**40)])
def test_counter_mask_matches_jax(size, lo, hi):
    h, mask = _hashes(size + 1)
    jc = jcounter.HashCounter(size).add(jnp.asarray(h), jnp.asarray(mask))
    table = convert.counter_from_numpy(jc.to_numpy(), CPU).table
    counts = jcounter.counter_get(jc.table, jnp.asarray(h))
    if hi == counter.INT32_MAX:
        want = jsketch.mask_by_frequency(jnp.asarray(h), counts, lo)
    else:
        want = jsketch.mask_by_frequency_range(jnp.asarray(h), counts, max(lo, -2**31),
                                               min(hi, 2**31 - 1))
    got = counter.counter_mask(table, _t(h), lo, hi)
    assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))
    assert np.array_equal(counter.counter_get_plain(table, _t(h)).numpy(), np.asarray(counts))


def test_depth_masks_match_jax():
    h, _ = _hashes(5)
    c = np.random.default_rng(5).integers(0, 9, h.shape).astype(np.int32)
    for occ in (0, 3, 9):
        want = jsketch.mask_by_frequency(jnp.asarray(h), jnp.asarray(c), occ)
        got = sketch.mask_by_frequency(_t(h), torch.from_numpy(c), occ)
        assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))
    want = jsketch.mask_by_frequency_range(jnp.asarray(h), jnp.asarray(c), 2, 5)
    got = sketch.mask_by_frequency_range(_t(h), torch.from_numpy(c), 2, 5)
    assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))


def test_sort_hashes_padded_matches_jax():
    h, mask = _hashes(6)
    wx, wl = jintersect.sort_hashes_padded(jnp.asarray(h), jnp.asarray(mask))
    gx, gl = intersect.sort_hashes_padded(_t(h), torch.from_numpy(mask))
    assert np.array_equal(gx.numpy().view(np.uint64), np.asarray(wx))
    assert np.array_equal(gl.numpy(), np.asarray(wl)) and gl.dtype == torch.int32
    assert (np.asarray(wx) == 0).any()  # zeros are kept, unlike a sketch


def _codes(seed, n=24, L=160):
    """Random codes with N runs, padding and a few short or empty rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 4  # at k=5, k-mers repeat within a row
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[:3] = (0, 4, L)
    for i, n_ in enumerate(lens):
        codes[i, n_:] = 255
    return codes, lens


@pytest.mark.parametrize("ks", [(5,), (12,), (5, 12)])
def test_distinct_hash_mask_matches_jax(ks):
    codes, lens = _codes(len(ks))
    wx, wf = jengine.distinct_hash_mask(codes, lens, ks)
    gx, gf = engine.distinct_hash_mask(torch.from_numpy(codes), torch.from_numpy(lens), ks)
    assert np.array_equal(gx.numpy().view(np.uint64), np.asarray(wx))
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    wf = np.asarray(wf)
    assert (wf & (np.asarray(wx) == 0)).sum(axis=1).max() == 1  # 0 counts once per row
    if ks == (5,):
        assert wf.sum() < sum(max(int(n) - 4, 0) for n in lens)  # repeats counted once


def _filter_counts():
    rng = np.random.default_rng(1)
    c = rng.integers(0, 6, size=(40, 7)).astype(np.int32)
    c[0] = 0                          # all zero: best -1, shared 0
    c[1] = [3, 5, 5, 1, 5, 0, 2]      # tie for the max: first wins
    c[2] = [5, 5, 5, 5, 5, 5, 5]      # all tied
    c[3] = [0, 0, 0, 0, 0, 0, 9]      # best last
    c[4] = [9, 8, 0, 0, 0, 0, 0]      # best first (diff against 0)
    c[5] = 0
    lens = rng.integers(0, 12, size=40).astype(np.int32)
    lens[5:8] = 0                     # empty rows: depth fails
    ref_lens = rng.integers(0, 15, size=7).astype(np.int32)
    return c, lens, ref_lens


@pytest.mark.parametrize("min_diff,min_matches", [(0, -1), (1, 3), (4, 5), (0, 9), (-1, 0)])
def test_argmax_filter_matches_jax(min_diff, min_matches):
    c, lens, ref_lens = _filter_counts()
    want = [np.asarray(a) for a in jengine.argmax_filter(c, min_diff, min_matches, lens,
                                                         ref_lens)]
    got = engine.argmax_filter(torch.from_numpy(c), min_diff, min_matches,
                               torch.from_numpy(lens), torch.from_numpy(ref_lens))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert want[0][0] == -1 and want[0][1] == 1 and want[2][0] == 0


def test_pack_filter_result_layout():
    t = torch.tensor
    out = pack_filter_result(t([2, -1]), t([7, 0]), t([5, 0]), t([True, False]),
                             t([False, True]), t([False, True]), t([True, False]))
    assert out.dtype == torch.int32
    assert out.tolist() == [[2, -1], [7, 0], [5, 0], [1, 0], [4, 3]]


@pytest.fixture(scope="module")
def small_panel():
    names, genomes = synth.make_panel(num_refs=6, genome_len=1500, seed=3)
    seqs = synth._ACGTN[genomes]
    return genomes, PyPacked([SeqRecord(n, s.tobytes()) for n, s in zip(names, seqs)])


def _read_codes(genomes, n, read_len, L, seed):
    reads, _ = synth.make_reads(genomes, n, read_len, noise=0.02, n_rate=0.01, seed=seed)
    codes = np.full((n, L), 255, np.uint8)
    codes[:, :read_len] = CODE_LUT[reads]
    codes[0] = 255                                    # an empty read
    codes[1, :read_len] = CODE_LUT[np.frombuffer(b"ACGT" * 40, np.uint8)[:read_len]]
    return codes                                      # read 1 matches nothing


@pytest.mark.parametrize("s,read_len,L", [(1000, 150, 160), (50, 150, 160)],
                         ids=["raw-rows", "sorted-rows"])
def test_filter_step_matches_jax(small_panel, s, read_len, L):
    genomes, packed = small_panel
    panel = build_ref_panel(packed, (12,), s, CPU)
    jsk, jlens = jengine.sketch_batch(packed.codes, (12,), s)
    table = jax_build_table(np.asarray(jsk), np.asarray(jlens)).table
    codes = _read_codes(genomes, 64, read_len, L, seed=s)
    jsk_r, jlens_r = jengine.sketch_batch(codes, (12,), s)
    keeps = []
    for md, mm in ((0, -1), (2, 8), (0, 40)):
        want = np.asarray(to_host(jengine.filter_sketches_table_packed(
            jsk_r, jlens_r, table, jlens, num_refs=6, min_diff=md, min_matches=mm)))
        got = engine.filter_codes_table(torch.from_numpy(codes), panel, (12,), s, md, mm)
        assert got.dtype == torch.int32 and got.shape == (5, 64)
        assert np.array_equal(got.numpy(), want)
        keeps.append(int(want[3].sum()))
    # the empty read and the one that matches nothing: best -1, never kept
    assert (want[0, :2] == -1).all() and (want[3, :2] == 0).all()
    assert 0 < keeps[0] < 64 and keeps[0] >= keeps[1] >= keeps[2]


def test_depth_filtered_and_informative_steps_on_a_jax_built_counter(small_panel):
    """A counter the JAX package filled, carried over by counter_from_numpy,
    gives the same -M read sketches, -I reference sketches and stream and
    filter steps as JAX."""
    genomes, packed = small_panel
    codes = _read_codes(genomes, 48, 150, 160, seed=3)
    lens = np.full(48, 150, np.int32)
    lens[0] = 0
    hashes, mask = jengine.hash_batch_with_mask(codes, lens, (12,))
    jc = jcounter.HashCounter(4099).add(hashes, mask)
    hc = convert.counter_from_numpy(jc.to_numpy(), CPU)
    assert np.array_equal(hc.table.numpy(), jc.to_numpy())
    x = torch.from_numpy(codes)
    for occ in (1, 2, 3):
        wsk, wl = jengine.sketch_batch_depth_filtered(codes, lens, jc.table, (12,), 50, occ)
        gsk, gl = engine.sketch_batch_depth_filtered(x, hc.table, (12,), 50, occ)
        assert np.array_equal(gsk.numpy().view(np.uint64), np.asarray(wsk))
        assert np.array_equal(gl.numpy(), np.asarray(wl))
    for occ in (1, 4):
        wsk, wl = jengine.sketch_batch_informative(codes, jc.table, (12,), 1000, occ)
        gsk, gl = engine.sketch_batch_informative(x, hc.table, (12,), 1000, occ)
        assert np.array_equal(gsk.numpy().view(np.uint64), np.asarray(wsk))
        assert np.array_equal(gl.numpy(), np.asarray(wl))

    panel = build_ref_panel(packed, (12,), 1000, CPU)
    jsk, jlens = jengine.sketch_batch(packed.codes, (12,), 1000)
    table = jax_build_table(np.asarray(jsk), np.asarray(jlens)).table
    wsk, wl = jengine.sketch_batch_depth_filtered(codes, lens, jc.table, (12,), 1000, 2)
    want = to_host(jengine.classify_sketches_table_packed(
        wsk, wl, table, num_refs=6, min_diff=0, min_matches=-1))
    got = engine.classify_codes_table(x, panel, (12,), 1000, 0, -1, hc.table, 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = to_host(jengine.filter_sketches_table_packed(
        wsk, wl, table, jlens, num_refs=6, min_diff=0, min_matches=5))
    got = engine.filter_codes_table(x, panel, (12,), 1000, 0, 5, hc.table, 2)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("distinct", [False, True], ids=["stream-I", "filter-I"])
def test_informative_panel_matches_jax(small_panel, distinct):
    from rkmh_tpu.commands.common import build_ref_panel as jax_build_panel

    _, packed = small_panel
    jp = jax_build_panel(packed, (12,), 200, max_samples=2, counter_size=1009,
                         distinct_counter=distinct)
    panel = build_ref_panel(packed, (12,), 200, CPU, max_samples=2, counter_size=1009,
                            distinct_counter=distinct)
    assert np.array_equal(panel.sketches.numpy().view(np.uint64), np.asarray(jp.sketches))
    assert np.array_equal(panel.lens.numpy(), np.asarray(jp.lens))
    assert np.array_equal(panel.table.numpy().view(np.uint32), to_host(jp.table[0]))


def test_counter_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="counter size"):
        counter.HashCounter(0, "cpu")
    with pytest.raises(ValueError, match="counter size"):
        counter.slots(torch.zeros(3, dtype=torch.int64), 2**31)
    table = torch.zeros(8, dtype=torch.int32)
    h = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        counter._counter_add_cuda(table.long(), h, None)
    with pytest.raises(ValueError, match="int64 hashes"):
        counter._counter_mask_cuda(table, h.int(), 0, 1)
    with pytest.raises(ValueError, match="mask"):
        counter._counter_add_cuda(table, h, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="1-D int32"):
        convert.counter_from_numpy(np.zeros(4, np.int64), CPU)


def test_filter_probe_kernel_wrapper_rejects_bad_ref_lens():
    table = torch.from_numpy(jax_build_table(np.full((3, 4), 2**64 - 1, np.uint64),
                                             np.zeros(3, np.int32)).table.view(np.int32))
    rows = torch.ones((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="ref_lens"):
        _panel_probe_filter_cuda(rows, None, table, 3, torch.zeros(2, dtype=torch.int32), 0, -1)
    got = panel_probe_filter(rows, None, table, 3, torch.zeros(3, dtype=torch.int32), 0, -1)
    assert got.tolist() == [[-1, -1], [0, 0], [0, 0], [0, 0], [0, 0]]
