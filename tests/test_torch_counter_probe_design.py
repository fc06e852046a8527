"""The premises of the K6 (counter add) and K3 (set probe) kernels'
designs, held against their plain versions and the JAX package on the CPU
at small sizes.

(a) K6 takes ``hash % size`` from a 64-bit multiply-high by a constant
made on the host (``ops/counter.remainder_magic``); a model of the
kernel's arithmetic in Python integers must equal the unsigned remainder.

(b) K6 derives the counter pass's window mask per element from the read
lengths, the padded length and the k values; a numpy model of
``counted()`` in csrc/counter.cu (with its 32-bit multiply-high division)
must equal ``window_mask``, and the JAX package's.

(c) K6 adds through bins: a numpy model of ``bin_scatter`` (tiles, zero
hashes added to slot 0 once a tile, room reserved per bin, what does not
fit added directly) and ``bin_merge`` (a small set that merges equal slots
and is flushed when it fills up) must leave ``counter_add_plain``'s table.

(d) K3 reads the set table in a packed layout (``pack_set_table``) and
splits a read into segments; ``set_probe_packed_plain`` probes that layout
segment by segment and must equal ``set_probe_plain`` on the logical table
and the JAX package's ``hpv16_comb`` chain, wherever the boundaries fall.

Inputs are made from a seed with numpy.  Tolerance: none (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rkmh_tpu.classify import engine as jengine
from rkmh_tpu.ops import intersect as jintersect
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu.ops.hashing import window_mask as jax_window_mask
from rkmh_tpu_torch.ops import counter
from rkmh_tpu_torch.ops.hashing import window_mask
from rkmh_tpu_torch.ops.set_probe import (
    SEGMENT,
    pack_set_table,
    packed_segment_counts,
    set_probe,
    set_probe_packed_plain,
    set_probe_plain,
)
from rkmh_tpu_torch.ops.sketch import SENTINEL, bottom_s_sketch

M64 = 2**64 - 1
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


# --------------------------------------------------------------------- (a)

@given(size=st.integers(1, 2**31 - 1), h=st.integers(0, M64))
@settings(max_examples=2000, deadline=None)
def test_magic_remainder_is_the_unsigned_remainder(size, h):
    magic, l = counter.remainder_magic(size)
    assert 0 < magic <= M64
    assert counter.magic_remainder(h, size, magic, l) == h % size


@pytest.mark.parametrize("size", [1, 2, 3, 7, 1009, 65536, 10_000_000, 200_000_000,
                                  800_000_000, 2**27, 2**30 + 1, 2**31 - 1])
def test_magic_remainder_at_the_edges_and_against_slots(size):
    magic, l = counter.remainder_magic(size)
    rng = np.random.default_rng(size % 97)
    hs = [0, 1, size - 1, size, size + 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, M64 - 1, M64,
          *(int(x) for x in rng.integers(0, 2**64, 300, dtype=np.uint64))]
    got = [counter.magic_remainder(h, size, magic, l) for h in hs]
    assert got == [h % size for h in hs]
    as_i64 = torch.tensor([h - 2**64 if h >= 2**63 else h for h in hs])
    assert counter.slots(as_i64, size).tolist() == got  # the plain version's slots


# --------------------------------------------------------------------- (b)

def _fast_div(n: int, d: int) -> int:
    """fast_div of csrc/counter.cu: any 32-bit n by a fixed d >= 1."""
    l = (d - 1).bit_length()
    m = ((1 << 32) * ((1 << l) - d)) // d + 1
    assert m < 2**32
    t = (m * n) >> 32
    return ((t + (((n - t) & 0xFFFFFFFF) >> min(l, 1))) & 0xFFFFFFFF) >> max(l - 1, 0)


def counted_model(lens: np.ndarray, L: int, ks) -> np.ndarray:
    """``counted()`` of csrc/counter.cu over every element of [B, wt]."""
    k_live = [k for k in ks if L - k + 1 > 0]
    col0 = np.cumsum([0] + [L - k + 1 for k in k_live])
    wt = int(col0[-1])
    out = np.zeros((len(lens), wt), bool)
    for i in range(out.size):
        row = _fast_div(i, wt)
        col = i - row * wt
        j = max(j for j in range(len(k_live)) if col >= col0[j])
        out[row, col] = col - col0[j] < int(lens[row]) - (k_live[j] - 1)
    return out


@pytest.mark.parametrize("ks", [(12,), (5,), (3, 7, 40), (16, 18), (33, 2), (1,)])
def test_in_kernel_window_mask_matches_window_mask(ks):
    L = 32
    lens = np.array([0, 1, 2, 4, 6, 17, 31, 32, 33], dtype=np.int32)  # some shorter than k
    want = window_mask(torch.from_numpy(lens), L, ks).numpy()
    assert want.shape[1] == sum(max(L - k + 1, 0) for k in ks)
    assert np.array_equal(counted_model(lens, L, ks), want)
    assert np.array_equal(want, np.asarray(jax_window_mask(lens, L, ks)))
    assert (~want).any()


def test_fast_div_model_divides():
    rng = np.random.default_rng(5)
    for d in (1, 2, 3, 139, 149, 20079, 2**31 - 1, *map(int, rng.integers(1, 2**31, 50))):
        for n in (0, 1, d - 1, d, d + 1, 2**32 - 1, *map(int, rng.integers(0, 2**32, 50))):
            assert _fast_div(n, d) == n // d


# --------------------------------------------------------------------- (c)

def binned_add_model(table: np.ndarray, hashes: np.ndarray, mask, tile: int, cap: int | None,
                     set_size: int, rng) -> dict:
    """K6's two kernels on a numpy table, in place.  ``hashes`` are uint64;
    the blocks of bin_scatter run in a shuffled order.  Returns what went
    which way."""
    size = table.size
    magic, l = counter.remainder_magic(size)
    h = hashes.reshape(-1)
    on = np.ones(h.size, bool) if mask is None else mask.reshape(-1)
    shift, nbins, plan_cap = counter.bin_plan(size, h.size)
    cap = plan_cap if cap is None else cap
    assert nbins <= counter.MAX_BINS and ((size - 1) >> shift) + 1 == nbins
    cursor = np.zeros(nbins, np.int64)
    bins = [[] for _ in range(nbins)]
    went = {"zeros": 0, "binned": 0, "direct": 0, "flushes": 0, "adds": 0}
    tiles = list(range(0, h.size, tile))
    for t0 in (tiles[i] for i in rng.permutation(len(tiles))):
        sl = slice(t0, t0 + tile)
        hv = h[sl][on[sl]]
        zeros = int((hv == 0).sum())
        if zeros:
            table[0] += zeros  # one add a block
            went["zeros"] += zeros
        slots = np.array([counter.magic_remainder(int(x), size, magic, l) for x in hv[hv != 0]],
                         dtype=np.int64)
        for b in np.unique(slots >> shift):
            mine = slots[slots >> shift == b]
            at = cursor[b]
            cursor[b] += mine.size  # the room is reserved whether it exists or not
            fits = max(0, min(mine.size, cap - at))
            bins[b].extend(mine[:fits].tolist())
            for s in mine[fits:].tolist():  # the bin's list is full
                table[s] += 1
            went["binned"] += fits
            went["direct"] += mine.size - fits
    for b in range(nbins):
        assert len(bins[b]) == min(cursor[b], cap)
        merged = {}
        for key in bins[b]:
            if key not in merged and len(merged) == set_size:  # the set fills up: flush
                for s, c in merged.items():
                    table[s] += c
                went["adds"] += len(merged)
                merged = {}
                went["flushes"] += 1
            merged[key] = merged.get(key, 0) + 1
        for s, c in merged.items():
            assert s >> shift == b  # a bin owns a range of the table
            table[s] += c
        went["adds"] += len(merged)
    return went


def _hashes(seed, shape, zeros=0.05):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    h[rng.random(shape) < zeros] = 0
    flat = h.reshape(-1)
    flat[1::5] = flat[::5][: flat[1::5].size]  # repeats
    return h, rng


def _plain_sparse(h_u64, mask, size):
    """counter_add_plain's table as {slot: count}, from its own slot arithmetic."""
    x = torch.from_numpy(h_u64.view(np.int64).reshape(-1))
    if mask is not None:
        x = x[torch.from_numpy(mask.reshape(-1))]
    s, c = np.unique(counter.slots(x, size).numpy(), return_counts=True)
    return dict(zip(s.tolist(), c.tolist()))


@pytest.mark.parametrize("size", [200_000_000, 10_000_000, 1 << 20, 1009, 100, 7, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_binned_add_model_leaves_the_plain_table(size, masked):
    h, rng = _hashes(size % 1000 + masked, (40, 37))
    assert (h >= 2**63).any() and (h == 0).sum() > 10
    mask = rng.random(h.shape) < 0.8 if masked else None
    want = _plain_sparse(h, mask, size)
    if size <= 1 << 20:  # a table the CPU can hold: against the plain version itself
        table = torch.zeros(size, dtype=torch.int32)
        counter.counter_add_plain(table, torch.from_numpy(h.view(np.int64)),
                                  None if mask is None else torch.from_numpy(mask))
        got = np.zeros(size, np.int64)
        went = binned_add_model(got, h, mask, tile=64, cap=None, set_size=8, rng=rng)
        assert np.array_equal(got, table.numpy())
    else:  # only the slots that are touched
        got = _SparseTable(size)
        went = binned_add_model(got, h, mask, tile=64, cap=None, set_size=8, rng=rng)
        assert got.cells == want
    assert went["zeros"] == (int((h == 0).sum()) if mask is None else int((h[mask] == 0).sum()))
    assert went["direct"] == 0 and went["binned"] > 0
    assert sum(want.values()) == (h.size if mask is None else int(mask.sum()))


class _SparseTable:
    """A counter table of any size that holds only the slots touched."""

    def __init__(self, size):
        self.size, self.cells = size, {}

    def __setitem__(self, slot, value):
        self.cells[int(slot)] = int(value)

    def __getitem__(self, slot):
        return self.cells.get(int(slot), 0)


def test_binned_add_model_sparse_table_adds():
    t = _SparseTable(10)
    t[3] += 2
    t[3] += 1
    assert t.cells == {3: 3} and t[4] == 0


@pytest.mark.parametrize("case", ["hot slot 0", "one value", "tiny cap", "empty mask",
                                  "table smaller than the bins"])
def test_binned_add_model_on_skewed_inputs(case):
    size = {"table smaller than the bins": 100}.get(case, 1009)
    h, rng = _hashes(len(case), (30, 41))
    mask, cap = None, None
    if case == "hot slot 0":
        h[rng.random(h.shape) < 0.7] = 0           # N-rich reads
        h[0, :5] = (1009, 2018, 1009 * 2**40, 0, 0)  # non-zero hashes of slot 0
    elif case == "one value":
        h[:] = np.uint64(2**63 + 12345)            # a poly-A input: one slot
        cap = 50
    elif case == "tiny cap":
        cap = 1                                     # nearly every element goes directly
    elif case == "empty mask":
        mask = np.zeros(h.shape, bool)
    table = torch.zeros(size, dtype=torch.int32)
    counter.counter_add_plain(table, torch.from_numpy(h.view(np.int64)),
                              None if mask is None else torch.from_numpy(mask))
    got = np.zeros(size, np.int64)
    went = binned_add_model(got, h, mask, tile=128, cap=cap, set_size=4, rng=rng)
    assert np.array_equal(got, table.numpy())
    if case == "hot slot 0":
        assert went["zeros"] > 800 and int(table[0]) >= went["zeros"] + 3
    if case in ("one value", "tiny cap"):
        assert went["direct"] > 0 and went["binned"] > 0
    if case == "empty mask":
        assert went == {"zeros": 0, "binned": 0, "direct": 0, "flushes": 0, "adds": 0}
        assert int(table.sum()) == 0
    if case == "table smaller than the bins":
        assert counter.bin_plan(size, h.size)[:2] == (0, 100)  # one bin a slot


@pytest.mark.parametrize("size,n", [(1, 5), (7, 10**6), (512, 1), (513, 4096), (1009, 610_304),
                                    (10_000_000, 2_441_216), (200_000_000, 2_441_216),
                                    (1 << 27, 2_441_216), (800_000_000, 10_280_448),
                                    (2**31 - 1, 1 << 32)])
def test_bin_plan_covers_the_table(size, n):
    shift, bins, cap = counter.bin_plan(size, n)
    assert 1 <= bins <= counter.MAX_BINS
    assert (size - 1) >> shift == bins - 1       # the last slot falls in the last bin
    assert bins > counter.MAX_BINS // 2 or shift == 0  # as many bins as the limit lets
    assert cap * bins >= 2 * n                   # room for twice a uniform input


@pytest.mark.parametrize("copies,pays", [(1, False), (6, True)])
def test_merge_statistics_choose_the_route(copies, pays):
    # what bin_merge reports (elements merged, adds sent to the table) tells a
    # batch that repeats its k-mers, where the bins pay, from one that does not
    rng = np.random.default_rng(copies)
    h = np.tile(rng.integers(1, 2**64, size=3000 // copies, dtype=np.uint64), copies)
    rng.shuffle(h)
    got = _SparseTable(200_000_000)
    went = binned_add_model(got, h, None, tile=256, cap=None, set_size=4096, rng=rng)
    assert went["binned"] == h.size and went["flushes"] == 0
    assert went["adds"] == len(got.cells) <= h.size // copies
    assert counter.merge_pays(went["binned"], went["adds"]) is pays
    assert counter.merge_pays(2, 1) and not counter.merge_pays(199, 100)


def test_counter_add_windows_on_the_cpu_is_the_plain_add_of_the_window_mask():
    h, _ = _hashes(3, (6, 21 + 28))
    hashes = torch.from_numpy(h.view(np.int64))
    lens = torch.tensor([0, 3, 12, 30, 32, 40])
    want = counter.counter_add_plain(torch.zeros(1009, dtype=torch.int32), hashes,
                                     window_mask(lens, 32, (12, 5)))
    got = counter.HashCounter(1009).add_windows(hashes, lens, 32, (12, 5)).table
    assert torch.equal(got, want) and int(got.sum()) == int(window_mask(lens, 32, (12, 5)).sum())
    assert counter.HashCounter(1009).add_windows(hashes, lens, 32, (12, 5)).binned is None


def test_counter_add_kernel_wrapper_rejects_what_it_cannot_take():
    table = torch.zeros(64, dtype=torch.int32)
    hashes = torch.zeros((3, 21), dtype=torch.int64)
    lens = torch.tensor([5, 6, 7])
    with pytest.raises(ValueError, match="not the windows"):
        counter._counter_add_cuda(table, hashes, None, (lens, 32, (11,)))
    with pytest.raises(ValueError, match="not the windows"):
        counter._counter_add_cuda(table, hashes, None, (lens[:2], 32, (12,)))
    with pytest.raises(ValueError, match="bool"):
        counter._counter_add_cuda(table, hashes, torch.zeros((3, 21), dtype=torch.uint8))
    with pytest.raises(ValueError, match="int64 hashes"):
        counter._counter_add_cuda(table, hashes.int(), None)


# --------------------------------------------------------------------- (d)

def _jax_set_table(rng, pool, T, U, S, per_ref=60):
    """A set table over T + U references with S slots a bucket, from the
    JAX package's ``build_panel_table`` (types 1 and 2 hold the same set)."""
    ref_rows = [rng.choice(pool, per_ref) for _ in range(T + U)]
    if T >= 3:
        ref_rows[2] = ref_rows[1]
    cleaned = [np.unique(r[r != 0]) for r in ref_rows]
    width = max(map(len, cleaned))
    mat = np.full((T + U, width), SENT, dtype=np.uint64)
    for i, r in enumerate(cleaned):
        mat[i, : len(r)] = r
    lens = np.array([len(r) for r in cleaned], np.int32)
    pt = jlookup.build_panel_table(mat, lens, num_refs=T + U, slots=S, policy="compact")
    assert pt.table.shape[1] == S * (3 + pt.mask_words)
    return pt, ref_rows


def _sorted_rows(rng, pool, n_rows, width):
    sk = np.full((n_rows, width), SENT, dtype=np.uint64)
    lens = rng.integers(0, width + 1, n_rows).astype(np.int32)
    for r in range(n_rows):
        sk[r, : lens[r]] = np.sort(rng.choice(pool, size=lens[r]))  # with repeats
    return sk, lens


@pytest.mark.parametrize("S", [8, 12])
@pytest.mark.parametrize("T,U", [(20, 5), (182, 14), (250, 30)], ids=["Wm1", "Wm7", "Wm9"])
def test_packed_probe_matches_plain_and_the_jax_chain(S, T, U):
    rng = np.random.default_rng(S * 1000 + T)
    pool = rng.integers(1, 2**64 - 1, size=400, dtype=np.uint64)
    assert (pool >= 2**63).any()
    pt, ref_rows = _jax_set_table(rng, pool, T, U, S)
    full, lens = _sorted_rows(rng, np.concatenate([pool, rng.integers(1, 2**63, 80, np.uint64)]),
                              20, 96)
    lens[3] = min(lens[3], 60)  # a read tied between types 1, 2
    full[3] = SENT
    full[3, : lens[3]] = np.sort(ref_rows[1][: lens[3]])
    occ = np.asarray(jintersect.occ_ranks(full)).astype(np.uint32)
    qmask = (np.arange(96)[None, :] < lens[:, None]) & (full != SENT)
    lo, hi = full.astype(np.uint32), (full >> np.uint64(32)).astype(np.uint32)
    rows = pt.table[np.asarray(jlookup.bucket_indices(lo, hi, occ, pt.table.shape[0]))]
    jax_want = np.asarray(jengine.hpv16_comb_finish(jnp.asarray(rows), lo, hi, occ, qmask,
                                                    num_types=T, num_uniq=U))
    table = torch.from_numpy(pt.table.view(np.int32))
    x, ln = torch.from_numpy(full.view(np.int64)), torch.from_numpy(lens)
    want = set_probe_plain(x, ln, table, T, U)
    assert np.array_equal(want.numpy(), jax_want)

    packed = pack_set_table(table, T + U)
    Wm = (T + U + 31) // 32
    assert packed.num_slots == S and packed.mask_words == Wm
    assert packed.keys.shape == (table.shape[0], 16)  # S lo words + the bitmap in 64 bytes
    assert packed.slots.shape == (table.shape[0] * S, 4 * -(-(1 + Wm) // 4))
    occupied = int((table.view(-1, 3 + Wm, S)[:, 2] == 0).sum())
    bitmap = packed.keys[:, -1].to(torch.int64) & 0xFFFFFFFF
    assert sum(int(((bitmap >> s) & 1).sum()) for s in range(S)) == occupied > 0
    for bounds in (None, [0], [0, 1, 2, 50, 95]):
        assert torch.equal(set_probe_packed_plain(x, ln, packed, T, U, bounds), want)
    assert torch.equal(set_probe(x, ln, packed, T, U), want)  # the CPU path takes either
    assert int(want[3, 0]) == 1 and int(want[:, 1].max()) > 1


def _port_set_table(seed, T, U, t):
    from rkmh_tpu_torch.ops.lookup import build_set_table

    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=4 * t, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    rows = [rng.choice(pool, t) for _ in range(T + U)]
    table = torch.from_numpy(build_set_table(rows, num_refs=T + U).table.view(np.int32))
    return table, pool, rng


@pytest.mark.parametrize("seed", range(4))
def test_split_at_any_boundaries_merges_to_the_unsplit_result(seed):
    T, U = 30, 10
    table, pool, rng = _port_set_table(seed, T, U, 96)
    packed = pack_set_table(table, T + U)
    raw = rng.choice(np.concatenate([pool, rng.integers(1, 2**63, len(pool), np.int64)]),
                     size=(8, 300))
    raw[:, 1::3] = raw[:, ::3]  # runs of equal values: some cross a boundary
    raw[:, 2::3] = raw[:, ::3]
    raw[rng.random(raw.shape) < 0.05] = 0
    full, lens = bottom_s_sketch(torch.from_numpy(raw), 300)
    full[2], lens[2] = SENTINEL, 0  # empty reads
    full[5], lens[5] = SENTINEL, 0
    want = set_probe_plain(full, lens, table, T, U)
    assert int(want[:, 1].max()) > 5 and (want[2] == 0).all()
    for _ in range(5):
        cuts = sorted({0, *map(int, rng.integers(1, 300, rng.integers(1, 12)))})
        assert torch.equal(set_probe_packed_plain(full, lens, packed, T, U, cuts), want), cuts
    # a run that crosses a boundary is counted once, by the segment that holds its start
    row = full[0]
    inside = next(i for i in range(1, int(lens[0])) if row[i] == row[i - 1])
    whole = packed_segment_counts(full, lens, packed, T + U, 0, 300)
    split = (packed_segment_counts(full, lens, packed, T + U, 0, inside)
             + packed_segment_counts(full, lens, packed, T + U, inside, 300))
    assert torch.equal(split, whole)


def test_one_long_read_among_short_ones_splits_into_segments():
    T, U = 12, 4
    table, pool, rng = _port_set_table(9, T, U, 400)
    packed = pack_set_table(table, T + U)
    n = 20_000
    raw = np.zeros((4, n), np.int64)
    raw[0] = rng.choice(np.concatenate([pool, rng.integers(1, 2**63, 4000, np.int64)]), n)
    for r, short in ((1, 700), (3, 40)):  # row 2 stays empty
        raw[r, :short] = rng.choice(pool, short)
    full, lens = bottom_s_sketch(torch.from_numpy(raw), n)
    assert lens.tolist()[1:] == [700, 0, 40] and int(lens[0]) > 19_000
    want = set_probe_plain(full, lens, table, T, U)
    assert -(-int(lens[0]) // SEGMENT) == 10  # ten blocks for the long read, one for the others
    assert torch.equal(set_probe_packed_plain(full, lens, packed, T, U), want)
    assert torch.equal(set_probe_packed_plain(full, lens, packed, T, U, [0, 1999, 2000, 19_999]),
                       want)
    assert int(want[0, 1]) > 100 and (want[2] == 0).all()


def test_pack_set_table_rejects_what_the_kernel_cannot_probe():
    table = torch.zeros((4, 2 * (3 + 1)), dtype=torch.int32)
    table[:, 4:6] = -1  # empty slots
    table[1, 4] = 1     # an entry with occ 1: a panel table, not a set table
    with pytest.raises(ValueError, match="not a set table"):
        pack_set_table(table, 20)
    with pytest.raises(ValueError, match="at most 31 slots"):
        pack_set_table(torch.zeros((2, 32 * 4), dtype=torch.int32), 20)
