"""The panel probe past 8,192 references (K11's function) vs the JAX chain.

At R = 8,193 and 9,000 the port's plain versions, ``panel_probe_plain``
and ``panel_probe_filter_plain`` (what K11 must match on the card), are
held against the JAX package's ``lookup_intersection_counts_masked`` then
``argmax_stream`` / ``argmax_filter``, on a table the JAX host builder
made, in both row modes: raw rows with prefix-equality ranks, and sorted
sketches with lens.  The inputs (``bench/wide_inputs.straddling_panel``,
made from a seed) put ties and maxima on both sides of reference 8,192
and hold duplicate-heavy rows.  K11's own layout, ``WideTable``
(``pack_wide_table``), must keep every occupied slot, and its plain
version ``panel_probe_wide_packed_plain`` must equal the plain versions on
the logical table at R = 8,193 and 9,000 (and K2's function at R = 8,192).
Also: what the K11 wrapper refuses.  Tolerance: none, every output is an
integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.classify import engine as jengine
from rkmh_tpu.ops import intersect as jintersect
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu_torch.bench.wide_inputs import PAST, straddling_panel
from rkmh_tpu_torch.ops.intersect import prefix_eq_ranks
from rkmh_tpu_torch.ops.probe import (
    MAX_REFS,
    ROW_WORDS,
    WideTable,
    _panel_probe_cuda,
    _panel_probe_filter_cuda,
    device_table,
    pack_filter_result,
    pack_result,
    pack_wide_table,
    panel_probe,
    panel_probe_filter,
    panel_probe_filter_plain,
    panel_probe_plain,
    panel_probe_wide_packed_plain,
)
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch


@pytest.fixture(scope="module", params=[PAST + 1, 9000])
def wide(request):
    R = request.param
    ref_sk, ref_lens, reads, set_lens = straddling_panel(R, seed=R, n_reads=16)
    table = jlookup.build_panel_table(ref_sk.view(np.uint64), ref_lens).table
    return R, table, torch.from_numpy(reads), set_lens


def _jax_counts(rows, lens, table, R):
    """The JAX chain's [B, R] counts and sketch lengths in either row mode."""
    x = rows.numpy().view(np.uint64)
    if lens is None:
        valid = x != 0
        occ = prefix_eq_ranks(rows).numpy().astype(np.int32)
        sk_lens = valid.sum(axis=1).astype(np.int32)
    else:
        n = x.shape[1]
        sk_lens = lens.numpy()
        valid = (np.arange(n)[None, :] < sk_lens[:, None]) & (x != np.uint64(2**64 - 1))
        occ = np.asarray(jintersect.occ_ranks(jnp.asarray(x)))
    counts = jlookup.lookup_intersection_counts_masked(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(occ), (jnp.asarray(table),), R)
    return counts, jnp.asarray(sk_lens)


@pytest.mark.parametrize("mode", ["raw", "sorted"])
def test_wide_probe_plain_matches_the_jax_chain(wide, mode):
    R, table, raw, set_lens = wide
    rows, lens = (raw, None) if mode == "raw" else bottom_s_sketch(raw, 32)
    t = torch.from_numpy(table.view(np.int32))
    counts, sk_lens = _jax_counts(rows, lens, table, R)
    ref_lens = torch.from_numpy(set_lens)
    for md, mm in ((0, -1), (1, 9), (-1, 0)):
        want = pack_result(*(torch.from_numpy(np.asarray(a)) for a in
                             jengine.argmax_stream(counts, md, mm, sk_lens)))
        got = panel_probe_plain(rows, lens, t, R, md, mm)
        assert torch.equal(got, want), (md, mm)
        want_f = pack_filter_result(*(torch.from_numpy(np.asarray(a)) for a in
                                      jengine.argmax_filter(counts, md, mm, sk_lens,
                                                            jnp.asarray(set_lens))))
        assert torch.equal(panel_probe_filter_plain(rows, lens, t, R, ref_lens, md, mm), want_f)
    best, shared = got[0].tolist(), got[1].tolist()
    # the straddling cases (bench/wide_inputs): first max below, first max
    # past 8,192, a tie across it; X's three ranks hit
    assert best[:3] == [100, PAST, PAST - 2] and shared[:3] == [10, 12, 8]
    assert shared[5] == 3


def test_pack_wide_table_keeps_every_occupied_slot(wide):
    R, table, _, _ = wide
    t = torch.from_numpy(table.view(np.int32))
    packed = pack_wide_table(t, R)
    nb, width = t.shape
    S = packed.num_slots
    Wm = width // S - 3
    assert (Wm, packed.num_refs, packed.num_buckets) == (-(-R // 32), R, nb)
    lanes = table.view(np.uint32).reshape(nb, 3 + Wm, S)
    occupied = lanes[:, 2] != 0xFFFFFFFF
    slots = packed.slots.numpy().view(np.uint32).reshape(nb, S, 4)
    assert np.array_equal(slots[..., 0], lanes[:, 1]) and np.array_equal(slots[..., 1], lanes[:, 2])
    assert np.array_equal(slots[..., 2], lanes[:, 0])
    entry = packed.slots.numpy().reshape(nb, S, 4)[..., 3]
    assert np.array_equal(entry[occupied], np.arange(int(occupied.sum())))
    assert (entry[~occupied] == -1).all()
    rows = packed.rows.numpy().view(np.uint32)
    assert rows.shape == (occupied.sum(), ROW_WORDS * -(-Wm // ROW_WORDS))
    b, sl = np.nonzero(occupied)
    assert np.array_equal(rows[:, :Wm], lanes[b, 3:, sl]) and (rows[:, Wm:] == 0).all()
    assert packed.nbytes == 4 * (packed.slots.numel() + packed.rows.numel()) < t.numel() * 4


@pytest.mark.parametrize("mode", ["raw", "sorted"])
def test_wide_packed_plain_equals_the_plain_versions(wide, mode):
    R, table, raw, set_lens = wide
    rows, lens = (raw, None) if mode == "raw" else bottom_s_sketch(raw, 32)
    t = torch.from_numpy(table.view(np.int32))
    packed = pack_wide_table(t, R)
    ref_lens = torch.from_numpy(set_lens)
    for md, mm in ((0, -1), (1, 9), (-1, 0)):
        want = panel_probe_plain(rows, lens, t, R, md, mm)
        assert torch.equal(panel_probe_wide_packed_plain(rows, lens, packed, R, md, mm), want)
        assert torch.equal(panel_probe(rows, lens, packed, R, md, mm), want)  # the CPU route
        want_f = panel_probe_filter_plain(rows, lens, t, R, ref_lens, md, mm)
        assert torch.equal(panel_probe_wide_packed_plain(rows, lens, packed, R, md, mm,
                                                         ref_lens), want_f)
        assert torch.equal(panel_probe_filter(rows, lens, packed, R, ref_lens, md, mm), want_f)
    assert want[0, :3].tolist() == [100, PAST, PAST - 2]


@pytest.mark.parametrize("mode", ["raw", "sorted"])
def test_wide_packed_plain_gives_k2s_answer_at_8192(mode):
    """At R = 8,192, where K2 runs too, the packed plain version gives K2's
    function (``panel_probe_plain`` on the logical table) on the same rows."""
    rng = np.random.default_rng(8192)
    pool = rng.integers(1, 2**63, size=800, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    sk = np.sort(rng.choice(pool, (MAX_REFS, 12)).view(np.uint64), axis=1).view(np.int64)
    t = torch.from_numpy(build_table(sk))
    raw = torch.from_numpy(rng.choice(pool, (20, 90)))
    raw[rng.random(raw.shape) < 0.1] = 0
    rows, lens = (raw, None) if mode == "raw" else bottom_s_sketch(raw, 40)
    packed = pack_wide_table(t, MAX_REFS)
    ref_lens = torch.from_numpy(rng.integers(0, 40, MAX_REFS).astype(np.int32))
    for md, mm in ((0, -1), (1, 3)):
        want = panel_probe_plain(rows, lens, t, MAX_REFS, md, mm)
        assert torch.equal(panel_probe_wide_packed_plain(rows, lens, packed, MAX_REFS, md, mm),
                           want)
        assert torch.equal(panel_probe_wide_packed_plain(rows, lens, packed, MAX_REFS, md, mm,
                                                         ref_lens),
                           panel_probe_filter_plain(rows, lens, t, MAX_REFS, ref_lens, md, mm))
    assert int(want[1].max()) > 0


def build_table(sk):
    return jlookup.build_panel_table(sk.view(np.uint64)).table.view(np.int32)


def test_device_table_packs_only_past_max_refs_on_a_gpu():
    R = MAX_REFS + 1
    table = torch.zeros((4, 2 * (3 + 257)), dtype=torch.int32)
    table.view(4, 3 + 257, 2)[:, 2] = -1  # every slot empty
    on_cpu = device_table(table.numpy(), R, "cpu")  # the CPU keeps the logical table
    assert isinstance(on_cpu, torch.Tensor) and torch.equal(on_cpu, table)
    empty = pack_wide_table(table, R)
    assert empty.rows.shape == (0, 288) and (empty.slots[:, 3] == -1).all()
    assert empty.num_buckets == 4 and empty.nbytes == 4 * 8 * 4


def test_wide_probe_wrapper_refuses_what_it_cannot_take():
    R = MAX_REFS + 1
    Wm = -(-R // 32)
    table = torch.zeros((4, 2 * (3 + Wm)), dtype=torch.int32)
    table.view(4, 3 + Wm, 2)[:, 2] = -1  # every slot empty
    packed = pack_wide_table(table, R)
    rows = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="counters"):  # K2 forced past its counters
        _panel_probe_cuda(rows, None, table, R, 0, -1, wide=False)
    with pytest.raises(ValueError, match="not fit"):  # a raw row of 20,000 hashes
        _panel_probe_cuda(torch.zeros((2, 20000), dtype=torch.int64), None, packed, R, 0, -1)
    with pytest.raises(ValueError, match="table width"):  # too few mask words for K2
        _panel_probe_cuda(rows, None, torch.zeros((4, 2 * (3 + 8)), dtype=torch.int32),
                          300, 0, -1)
    with pytest.raises(ValueError, match="ref_lens"):
        _panel_probe_filter_cuda(rows, None, packed, R, torch.zeros(3, dtype=torch.int32), 0,
                                 -1)
    with pytest.raises(ValueError, match="WideTable: pack"):  # K11 on the logical table
        _panel_probe_cuda(rows, None, table, R, 0, -1)
    with pytest.raises(ValueError, match="WideTable: pack"):
        _panel_probe_filter_cuda(rows, None, table, R, torch.zeros(R, dtype=torch.int32), 0, -1)
    with pytest.raises(ValueError, match="not a WideTable"):  # K2 on the packed table
        _panel_probe_cuda(rows, None, packed, 300, 0, -1, wide=False)
    with pytest.raises(ValueError, match="WideTable of 8193 references probed for 9000"):
        _panel_probe_cuda(rows, None, packed, 9000, 0, -1)
    with pytest.raises(ValueError, match="int64 rows"):
        _panel_probe_cuda(rows.to(torch.int32), None, packed, R, 0, -1)
    with pytest.raises(ValueError, match="WideTable of 9000"):
        panel_probe_wide_packed_plain(rows, None, packed, 9000, 0, -1)
    odd = WideTable(packed.slots, torch.zeros((3, 258), dtype=torch.int32), 2, Wm, R)
    with pytest.raises(ValueError, match="multiple of 4 words"):  # K11's 16-byte loads
        _panel_probe_cuda(rows, None, odd, R, 0, -1)
    assert isinstance(packed, WideTable)
