"""The CUDA kernels of rkmh_tpu_torch against their plain PyTorch versions.

The kernel tests need an NVIDIA GPU (marker ``cuda``) and skip without
one.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)  Inputs
are made from a seed with numpy; tolerance: none, every output is an
integer and must be equal, but for K12's float sums (``sparse_margin``:
1e-5 of the sum of |terms| + 1e-6, ``bench/margin_inputs.py`` says why;
K12's gradient, run twice, is equal).
"""

import numpy as np
import pytest
import torch

from rkmh_tpu_torch import call_engine, convert, synth
from rkmh_tpu_torch.bench import fill_cases, map_cases
from rkmh_tpu_torch.bench.margin_inputs import check_margins, edge_cases, margin_case
from rkmh_tpu_torch.bench.wide_inputs import PAST, straddling_panel
from rkmh_tpu_torch.commands import call_cmd
from rkmh_tpu_torch.commands.common import load_packed
from rkmh_tpu_torch.ops import counter, gather, hashmap, kernels, lookup
from rkmh_tpu_torch.ops.hashing import (
    kmer_window_hashes_plain,
    multi_k_window_hashes,
    window_mask,
)
from rkmh_tpu_torch.ops.lookup import build_panel_table, build_set_table
from rkmh_tpu_torch.ops.probe import (
    WideTable,
    _panel_probe_cuda,
    _panel_probe_filter_cuda,
    device_table,
    pack_wide_table,
    panel_probe,
    panel_probe_filter,
    panel_probe_filter_plain,
    panel_probe_partial,
    panel_probe_partial_plain,
    panel_probe_plain,
    panel_probe_wide_packed_plain,
)
from rkmh_tpu_torch.parallel.mesh import build_sharded_tables, merge_tp_partials
from rkmh_tpu_torch.ops.set_probe import (
    _set_probe_cuda,
    merge_hpv16_partials,
    pack_set_table,
    set_probe,
    set_probe_partial,
    set_probe_partial_plain,
    set_probe_plain,
)
from rkmh_tpu_torch.ops.sketch import SENTINEL, bottom_s_sketch
from rkmh_tpu_torch.ops.sparse_margin import (
    _margins_grad_cuda,
    build_plan,
    pack_weights,
    sparse_margins,
    sparse_margins_packed,
    sparse_margins_plain,
    unpack_weights,
)
from rkmh_tpu_torch.ops.sorted_probe import (
    _sorted_probe_cuda,
    sorted_probe,
    sorted_probe_plain,
    sorted_probe_plain_dir,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(seed, shape):
    """Random codes with invalid ones (4, 5, 255) mixed in."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=shape).astype(np.uint8)
    c[rng.random(shape) < 0.02] = 4
    c[rng.random(shape) < 0.01] = 255
    return torch.from_numpy(c)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [*range(1, 34), 64, 100])  # packed k <= 32, byte-wise above
@pytest.mark.parametrize("L", [96, 160, 400])
def test_window_hash_kernel_matches_plain(cuda_device, k, L):
    # 37 rows: the flattened windows end inside a block
    codes = _codes(k + L, (37, L)).to(cuda_device)
    before = kernels.WINDOW_HASH.launches
    got = multi_k_window_hashes(codes, [k])
    torch.cuda.synchronize()
    assert kernels.WINDOW_HASH.launches == before + (k <= L)  # k > L: no windows
    assert got.shape == (37, max(L - k + 1, 0))
    assert torch.equal(got, kmer_window_hashes_plain(codes, k))


@pytest.mark.cuda
def test_window_hash_kernel_multi_k_and_short_rows(cuda_device):
    codes = _codes(3, (20, 160)).to(cuda_device)
    ks = [12, 16, 200, 33]  # k=200 > L contributes no columns
    got = multi_k_window_hashes(codes, ks)
    want = torch.cat([kmer_window_hashes_plain(codes, k) for k in ks], dim=-1)
    assert got.shape == (20, 149 + 145 + 128)
    assert torch.equal(got, want)
    # rows of one window each: a block's 256 windows span 256 rows
    tiny = _codes(4, (300, 32)).to(cuda_device)
    assert torch.equal(multi_k_window_hashes(tiny, [32, 31]),
                       torch.cat([kmer_window_hashes_plain(tiny, k) for k in (32, 31)], -1))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 18, 33])
def test_window_hash_kernel_hpv16_length_rows(cuda_device, k):
    codes = _codes(k, (5, 20096))  # a ~20 kb nanopore read padded to 128
    codes[1] = 0  # poly-A: every window the same canonical k-mer
    codes = codes.to(cuda_device)
    got = multi_k_window_hashes(codes, [k])
    torch.cuda.synchronize()
    assert torch.equal(got, kmer_window_hashes_plain(codes, k))
    assert (got[1] == got[1, 0]).all() and int(got[1, 0]) != 0


def _panel(seed, R, t, n_reads, width):
    """A table from sorted pool-drawn sketches, plus read rows."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=4 * t, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))  # high words >= 2**31
    sk = np.full((R, t), SENTINEL, dtype=np.int64)
    lens = rng.integers(t // 2, t + 1, R).astype(np.int32)
    for r in range(R):
        sk[r, : lens[r]] = np.sort(rng.choice(pool, lens[r]).view(np.uint64)).view(np.int64)
    table = torch.from_numpy(build_panel_table(sk, lens).table.view(np.int32))
    reads = rng.choice(np.concatenate([pool, rng.integers(1, 2**63, t, dtype=np.int64)]),
                       size=(n_reads, width))
    reads[rng.random(reads.shape) < 0.1] = 0  # invalid windows
    return table, torch.from_numpy(reads)


def _dup_panel(seed, R, width, n_reads=99):
    """A table in which references 0 and R-1 hold one value 40 times, and
    duplicate-heavy read rows: one value 40 times among others, a row of
    one value (a poly-A read's hashes), two values alternating."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=256, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    v = pool[0]
    sk = np.full((R, 64), SENTINEL, dtype=np.int64)
    lens = np.full(R, 64, np.int32)
    for r in range(R):
        vals = rng.choice(pool[1:], 64)
        if r in (0, R - 1):
            vals[:40] = v
        sk[r] = np.sort(vals.view(np.uint64)).view(np.int64)
    table = torch.from_numpy(build_panel_table(sk, lens).table.view(np.int32))
    reads = rng.choice(pool, size=(n_reads, width))
    reads[0::3, :40] = v
    reads[1::3] = v
    reads[2::3, ::2] = pool[5]
    reads[rng.random(reads.shape) < 0.05] = 0
    perm = np.argsort(rng.random(reads.shape), axis=1)
    return table, torch.from_numpy(np.take_along_axis(reads, perm, 1))


# the kernel keeps the counters of R <= 256 references in registers and
# of more in shared memory; 99 rows are not a multiple of its reads per block
PROBE_SHAPES = [(1, 64), (33, 149), (60, 149), (256, 149), (257, 149), (300, 256),
                (8192, 149), (60, 7000)]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 60, 256, 257, 8192])
def test_panel_probe_kernel_duplicate_heavy_rows(cuda_device, R):
    table, raw = _dup_panel(R, R, 149)
    ref_lens = torch.full((R,), 64, dtype=torch.int32, device=cuda_device)
    table, raw = table.to(cuda_device), raw.to(cuda_device)
    poly_a = multi_k_window_hashes(torch.zeros((5, 160), dtype=torch.uint8,
                                               device=cuda_device), [12])
    sk, lens = bottom_s_sketch(raw, 149)
    for rows, ln in ((raw, None), (sk, lens), (poly_a, None)):
        for md, mm in ((0, -1), (1, 20)):
            got = panel_probe(rows, ln, table, R, md, mm)
            torch.cuda.synchronize()
            assert torch.equal(got, panel_probe_plain(rows, ln, table, R, md, mm)), (R, md)
            got = panel_probe_filter(rows, ln, table, R, ref_lens, md, mm)
            assert torch.equal(got, panel_probe_filter_plain(rows, ln, table, R, ref_lens,
                                                             md, mm)), (R, md)
    want = panel_probe_plain(raw, None, table, R, 0, -1)
    assert int(want[1, 1]) == 40  # a row of one value: ranks 0..39 all hit


@pytest.mark.cuda
@pytest.mark.parametrize("R,width", PROBE_SHAPES)
def test_panel_probe_kernel_matches_plain(cuda_device, R, width):
    table, raw = _panel(R + width, R, 64, 99, width)
    table, raw = table.to(cuda_device), raw.to(cuda_device)
    # past 1000 the sketch keeps every element: a row of 7000 needs more
    # than the default 48 KB of shared memory
    sk, lens = bottom_s_sketch(raw, width if width > 1000 else width // 2)
    cases = [(sk, lens)] + ([(raw, None)] if width <= 256 else [])
    for rows, ln in cases:
        for md, mm in ((0, -1), (1, 3), (0, 30)):
            got = panel_probe(rows, ln, table, R, md, mm)
            torch.cuda.synchronize()
            want = panel_probe_plain(rows, ln, table, R, md, mm)
            assert torch.equal(got, want), (R, width, ln is None, md, mm)
    assert int(want[1].max()) > 0  # reads do match the panel


@pytest.mark.cuda
@pytest.mark.parametrize("R,width", PROBE_SHAPES)
def test_panel_probe_filter_kernel_matches_plain(cuda_device, R, width):
    table, raw = _panel(R + width + 1, R, 64, 99, width)
    raw[:4] = 0  # reads with no valid hash: depth fails, best -1
    raw[4:8] = torch.randint(1, 2**62, (4, width))  # reads that match nothing
    ref_lens = torch.from_numpy(np.random.default_rng(R).integers(0, 80, R).astype(np.int32))
    table, raw, ref_lens = table.to(cuda_device), raw.to(cuda_device), ref_lens.to(cuda_device)
    sk, lens = bottom_s_sketch(raw, width if width > 1000 else width // 2)
    cases = [(sk, lens)] + ([(raw, None)] if width <= 256 else [])
    before = kernels.PANEL_PROBE_FILTER.launches
    for rows, ln in cases:
        for md, mm in ((0, -1), (1, 3), (0, 30), (-1, 0)):
            got = panel_probe_filter(rows, ln, table, R, ref_lens, md, mm)
            torch.cuda.synchronize()
            want = panel_probe_filter_plain(rows, ln, table, R, ref_lens, md, mm)
            assert torch.equal(got, want), (R, width, ln is None, md, mm)
    assert kernels.PANEL_PROBE_FILTER.launches == before + 4 * len(cases)
    assert int(want[1].max()) > 0 and (want[0, :8] == -1).all()


def _sketches(seed, R, t=24, n_reads=256, width=149):
    """[R, t] sorted pool-drawn sketches (SENTINEL-padded), their lengths,
    read rows drawn from the pool (a tenth invalid) and filter's [R]
    reference lengths."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=4 * t, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    sk = np.full((R, t), SENTINEL, dtype=np.int64)
    lens = rng.integers(t // 2, t + 1, R).astype(np.int32)
    for r in range(R):
        sk[r, : lens[r]] = np.sort(rng.choice(pool, lens[r]).view(np.uint64)).view(np.int64)
    reads = rng.choice(pool, size=(n_reads, width))
    reads[rng.random(reads.shape) < 0.1] = 0
    return sk, lens, reads, rng.integers(0, 80, R).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("R,tp", [(60, 2), (600, 4), (600, 2), (20000, 2)])
def test_panel_probe_partial_kernel_matches_plain_and_merges(cuda_device, R, tp):
    # every route a tp shard takes: counters in registers (30 and 150
    # references a shard), in shared memory (300) and K11's (10,000); the
    # shards merged equal the unsharded kernel, stream and filter
    if R > PAST:
        sk, lens, reads, set_lens = straddling_panel(R, seed=R, n_reads=256, width=149)
    else:
        sk, lens, reads, set_lens = _sketches(R, R)
    tables, rps = build_sharded_tables(sk, lens, tp)
    logical = [torch.from_numpy(np.ascontiguousarray(t).view(np.int32)) for t in tables]
    shards = [device_table(t, rps, cuda_device) for t in logical]
    logical = [t.to(cuda_device) for t in logical]
    whole = device_table(torch.from_numpy(build_panel_table(sk, lens).table.view(np.int32)), R,
                         cuda_device)
    raw = torch.from_numpy(reads).to(cuda_device)
    set_lens = torch.from_numpy(set_lens).to(cuda_device)
    sk_rows, sk_lens = bottom_s_sketch(raw, 32)
    before = kernels.PANEL_PROBE_PARTIAL.launches
    for rows, ln in ((raw, None), (sk_rows, sk_lens)):
        for init in (-1, 0):
            got = [panel_probe_partial(rows, ln, t, rps, init) for t in shards]
            torch.cuda.synchronize()
            for g, t in zip(got, logical):
                assert torch.equal(g, panel_probe_partial_plain(rows, ln, t, rps, init))
            if init == -1:
                want = panel_probe(rows, ln, whole, R, 1, 3)
                assert torch.equal(merge_tp_partials(torch.stack(got), rps, 1, 3), want)
            else:
                want = panel_probe_filter(rows, ln, whole, R, set_lens, 1, 3)
                assert torch.equal(merge_tp_partials(torch.stack(got), rps, 1, 3, set_lens), want)
    assert kernels.PANEL_PROBE_PARTIAL.launches == before + 4 * tp


@pytest.mark.cuda
@pytest.mark.parametrize("size,parts", [(200_000_000, 4), (1009 * 3, 3)])
def test_counter_kernels_over_slot_ranges(cuda_device, size, parts):
    # K6 over each range (binned and direct, a mask tensor and the window
    # mask) puts the whole table's counts together; K7 over the ranges in
    # turn is the whole table's K7
    h, m = (t.to(cuda_device) for t in _hashes(size % 1000, (512, 149)))
    lens = torch.from_numpy(np.random.default_rng(parts).integers(0, 161, 512)).to(cuda_device)
    whole = torch.zeros(size, dtype=torch.int32, device=cuda_device)
    counter.counter_add_plain(whole, h, m)
    counter.counter_add_plain(whole, h, window_mask(lens, 160, [12]))
    n = size // parts
    adds = kernels.COUNTER_ADD.by_route.get("range", 0)
    for binned in (True, False):
        pieces = []
        for o in range(parts):
            t = torch.zeros(n, dtype=torch.int32, device=cuda_device)
            counter._counter_add_cuda(t, h, m, binned=binned, base=o * n, size=size)
            counter._counter_add_cuda(t, h, None, (lens, 160, [12]), binned=binned, base=o * n,
                                      size=size)
            pieces.append(t)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(pieces), whole), binned
    assert kernels.COUNTER_ADD.by_route["range"] == adds + 4 * parts
    for lo, hi in ((2, counter.INT32_MAX), (0, 1)):
        out = h
        for o in range(parts):
            out = counter.counter_mask(pieces[o], out, lo, hi, o * n, size)
        torch.cuda.synchronize()
        assert torch.equal(out, counter.counter_mask_plain(whole, h, lo, hi)), (lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("R,width", [(60, 1000), (257, 1000), (60, 12000)])
def test_panel_probe_kernel_wide_raw_rows(cuda_device, R, width):
    # raw rows past NOSORT_MAX_W, which the engine does not send but the
    # kernel takes: 3n ranks slots per read at 1000, n at 12,000 (3n would
    # not fit in shared memory), where the last row, of distinct values,
    # fills the table; 7 rows are no multiple of the reads per block
    table, raw = _panel(R + width + 2, R, 64, 7, width)
    first = raw[0][raw[0] != 0].unique()[:30]  # pool values: some hit
    raw[-1] = torch.from_numpy(np.random.default_rng(width).integers(1, 2**63, width))
    raw[-1, : first.numel()] = first
    assert raw[-1].unique().numel() == width
    ref_lens = torch.full((R,), 64, dtype=torch.int32)
    table, raw, ref_lens = table.to(cuda_device), raw.to(cuda_device), ref_lens.to(cuda_device)
    for md, mm in ((0, -1), (1, 3)):
        got = panel_probe(raw, None, table, R, md, mm)
        torch.cuda.synchronize()
        want = panel_probe_plain(raw, None, table, R, md, mm)
        assert torch.equal(got, want), (R, width, md, mm)
        got = panel_probe_filter(raw, None, table, R, ref_lens, md, mm)
        assert torch.equal(got, panel_probe_filter_plain(raw, None, table, R, ref_lens, md,
                                                         mm)), (R, width, md, mm)
    assert int(want[1].min()) > 0  # every read, the distinct one too, matches


@pytest.mark.cuda
def test_panel_probe_kernel_edge_shapes(cuda_device):
    empty = torch.from_numpy(
        build_panel_table(np.full((3, 4), SENTINEL, np.int64), np.zeros(3, np.int32))
        .table.view(np.int32)).to(cuda_device)
    assert empty.shape[0] == 1  # one bucket: the bucket shift is 32
    rows = torch.randint(1, 2**62, (5, 12), device=cuda_device)
    assert torch.equal(panel_probe(rows, None, empty, 3, 0, -1),
                       panel_probe_plain(rows, None, empty, 3, 0, -1))
    none = torch.zeros((0, 12), dtype=torch.int64, device=cuda_device)
    assert panel_probe(none, None, empty, 3, 0, -1).shape == (3, 0)
    no_cols = torch.zeros((4, 0), dtype=torch.int64, device=cuda_device)
    assert torch.equal(panel_probe(no_cols, None, empty, 3, 0, -1),
                       panel_probe_plain(no_cols, None, empty, 3, 0, -1))


def _set_table(seed, T, U, t):
    """A set table over T + U references drawn from one pool (types 1 and
    2 hold the same set, so reads tie between them), plus the pool."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=4 * t, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))  # high words >= 2**31
    rows = [rng.choice(pool, t) for _ in range(T + U)]
    if T >= 3:
        rows[2] = rows[1]
    table = torch.from_numpy(build_set_table(rows, num_refs=T + U).table.view(np.int32))
    return table, pool, rows, rng


def _sorted_rows(rng, pool, n_reads, width, dup=0.2):
    """Sorted read rows with duplicates, zeros (invalid windows) and
    strangers; returns (rows [B, width], lens [B])."""
    raw = rng.choice(np.concatenate([pool, rng.integers(1, 2**63, len(pool), np.int64)]),
                     size=(n_reads, width))
    raw[:, 1::7] = raw[:, ::7][:, : raw[:, 1::7].shape[1]]  # repeats
    raw[rng.random(raw.shape) < dup / 2] = 0
    return bottom_s_sketch(torch.from_numpy(raw), width)


@pytest.mark.cuda
@pytest.mark.parametrize("T,U,width", [(1, 0, 64), (30, 10, 500), (182, 14, 4000),
                                       (300, 40, 256)])
def test_set_probe_kernel_matches_plain(cuda_device, T, U, width):
    table, pool, rows, rng = _set_table(T + width, T, U, 96)
    full, lens = _sorted_rows(rng, pool, 64, width)
    k = min(96, width)  # a read tied between types 1 and 2 (type 0 of T = 1)
    src = rows[1] if T >= 3 else rows[0]
    full[3, :k] = torch.from_numpy(np.sort(src.view(np.uint64))[:k].view(np.int64))
    lens[3] = k
    full[5:8], lens[5:8] = SENTINEL, 0  # reads with no valid element
    table, full, lens = table.to(cuda_device), full.to(cuda_device), lens.to(cuda_device)
    packed = pack_set_table(table, T + U)  # once, on the card
    before = kernels.SET_PROBE.launches
    for n in (width, width // 2):  # all columns, and cut short of some lens
        got = set_probe(full[:, :n], lens, packed, T, U)
        torch.cuda.synchronize()
        want = set_probe_plain(full[:, :n], lens, table, T, U)
        assert torch.equal(got, want), (T, U, width, n)
    assert kernels.SET_PROBE.launches == before + 2
    with pytest.raises(ValueError, match="PackedSetTable"):
        set_probe(full, lens, table, T, U)  # the kernel never repacks a logical table
    assert int(want[:, 1].max()) > 1 and (want[5:8] == 0).all()
    assert int(want[3, 0]) == (1 if T >= 3 else 0)  # the first of the tied types


@pytest.mark.cuda
def test_set_probe_kernel_takes_a_40kb_read(cuda_device):
    table, pool, _, rng = _set_table(40, 182, 14, 2000)
    full, lens = _sorted_rows(rng, pool, 2, 40_000)
    packed = pack_set_table(table.to(cuda_device), 182 + 14)
    got = set_probe(full.to(cuda_device), lens.to(cuda_device), packed, 182, 14)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), set_probe_plain(full, lens, table, 182, 14))
    assert int(got[:, 1].min()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4, 8, 12, 20])  # 1, 2, 4, 4 and 8 vectors a key record
@pytest.mark.parametrize("T,U", [(20, 5), (182, 14), (250, 30)], ids=["Wm1", "Wm7", "Wm9"])
def test_set_probe_kernel_slot_widths_and_segments(cuda_device, monkeypatch, S, T, U):
    monkeypatch.setattr(lookup, "pick_slots", lambda *a, **k: S)
    table, pool, rows, rng = _set_table(S + T, T, U, 96)
    assert table.shape[1] == S * (3 + (T + U + 31) // 32)
    full, lens = _sorted_rows(rng, pool, 33, 700)
    full[:, 1::3] = full[:, ::3][:, : full[:, 1::3].shape[1]]  # runs that cross segments
    full, lens = bottom_s_sketch(full, 700)
    full[4], lens[4] = SENTINEL, 0           # an empty read: its one block writes zeros
    full[9, 40:], lens[9] = SENTINEL, 40     # a short read among longer ones
    want = set_probe_plain(full, lens, table, T, U)
    packed = pack_set_table(table.to(cuda_device), T + U)
    x, ln = full.to(cuda_device), lens.to(cuda_device)
    for seg in (32, 96, 512, 2048):  # 22, 8, 2 and 1 blocks a read
        got = _set_probe_cuda(x, ln, packed, T, U, seg=seg)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (S, T, U, seg)
    assert int(want[:, 1].max()) > 1 and (want[4] == 0).all()


@pytest.mark.cuda
def test_set_probe_kernel_batch_of_unequal_reads(cuda_device):
    # 512 reads of 0 to 9,000 elements: blocks of many reads' segments
    # finish in any order, and each read's last block takes its argmax
    table, pool, _, rng = _set_table(77, 182, 14, 2000)
    full, lens = _sorted_rows(rng, pool, 512, 9000, dup=0.02)
    keep = torch.from_numpy(rng.integers(0, 9001, 512).astype(np.int32))
    keep[::50] = 0
    lens = torch.minimum(lens, keep)
    full[torch.arange(9000)[None, :] >= lens[:, None]] = SENTINEL
    packed = pack_set_table(table.to(cuda_device), 182 + 14)
    x, ln = full.to(cuda_device), lens.to(cuda_device)
    want = set_probe_plain(x, ln, table.to(cuda_device), 182, 14)
    for _ in range(3):
        got = set_probe(x, ln, packed, 182, 14)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert (want[::50] == 0).all() and int(want[:, 1].max()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("T,U,tp", [(182, 14, 2), (182, 14, 4), (30, 10, 3), (5, 40, 4),
                                    (3, 1, 2)])
@pytest.mark.parametrize("width", [1500, 4000, 7000])  # reads of 1, 2 and 4 segments
def test_set_probe_partial_kernel_matches_plain_and_merges(cuda_device, T, U, tp, width):
    """K3's partial route on every tp shard against its plain version (the
    logical shard table), the shards merged against the whole table's K3,
    and the window (0, T + U) against rkmh_set_probe bit for bit; types 1
    and 2 hold one set, so reads tie between them, across the shard border
    at (3, 1, 2); (5, 40, 4) has shards without type columns."""
    from rkmh_tpu_torch.ops.lookup import build_sharded_set_tables_device

    table, pool, rows, rng = _set_table(T + tp + width, T, U, 200)
    full, lens = _sorted_rows(rng, pool, 24, width)
    lens[::5] = 0
    x, ln = full.to(cuda_device), lens.to(cuda_device)
    whole = set_probe(x, ln, pack_set_table(table.to(cuda_device), T + U), T, U)
    R = T + U + (-(T + U)) % tp
    h = torch.zeros((R, max(map(len, rows))), dtype=torch.int64)
    m = torch.zeros(h.shape, dtype=torch.bool)
    for i, r in enumerate(rows):
        h[i, : len(r)] = torch.from_numpy(np.asarray(r).view(np.int64))
        m[i, : len(r)] = True
    tables, rps = build_sharded_set_tables_device(h.to(cuda_device), m.to(cuda_device), tp)
    before = kernels.SET_PROBE_PARTIAL.by_route.get("partial", 0)
    parts = []
    for j in range(tp):
        shard = tables[j]
        got = set_probe_partial(x, ln, pack_set_table(shard, rps), j * rps, rps, T, U)
        torch.cuda.synchronize()
        assert torch.equal(got, set_probe_partial_plain(x, ln, shard, j * rps, rps, T, U)), j
        parts.append(got)
    assert kernels.SET_PROBE_PARTIAL.by_route["partial"] == before + tp
    assert torch.equal(merge_hpv16_partials(torch.stack(parts)), whole)
    assert torch.equal(set_probe_partial(x, ln, pack_set_table(table.to(cuda_device), T + U), 0,
                                         T + U, T, U), whole)
    assert int(whole[:, 1].max()) > 1 and (whole[::5] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 16, 33])
@pytest.mark.parametrize("n", [2, 4])
def test_call_scan_kernel_slices_with_a_base(cuda_device, k, n):
    """K9 with base > 0 on each slice of a reference (its deletions guarded
    on the global index) against ``_enumerate_plain`` at the same base and
    against the whole row's scan sliced."""
    ref, table = _call_case(k, seed=n)
    w = 100
    whole = call_engine.call_scan_plain(ref, table, k, w)
    P = ref.shape[0] - k + 1
    Pl = -(-P // n)
    padded = torch.full((n * Pl + k + 1,), 255, dtype=torch.uint8)
    padded[0] = 4
    padded[1: 1 + ref.shape[0]] = ref
    t = table.to(cuda_device)
    get = call_engine.plain_getter(table)
    halo = None
    for d in range(n):
        j0, j1 = d * Pl, min((d + 1) * Pl, P)
        pref = padded[j0: j0 + Pl + k + 1]
        got = call_engine.call_scan_slice(pref.to(cuda_device), t, k, w, Pl, j0,
                                          None if halo is None else halo.to(cuda_device))
        torch.cuda.synchronize()
        want = call_engine._enumerate_plain(pref[1:], get, k, got["depth"].cpu(),
                                            got["avg"].cpu(), got["site"].cpu(), 0, Pl, j0,
                                            int(pref[0]))
        for name, v in zip(("snp_depth", "snp_call", "max_rescue", "del_depth", "del_call"),
                           want):
            assert torch.equal(got[name].cpu(), v), (d, name)
        for name in whole:
            assert torch.equal(got[name][: j1 - j0].cpu(), whole[name][j0:j1]), (d, name)
        halo = got["depth"][-w:].cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 64, 512, 4096, 16384])
def test_lut_gather_kernels_match_plain(cuda_device, N):
    rng = np.random.default_rng(N)
    lut = torch.from_numpy(rng.integers(-2**31, 2**31, (N, 128)).astype(np.int32)).to(cuda_device)
    for M in (N, 3):
        idx = torch.from_numpy(rng.integers(0, N, (M, 128)).astype(np.int32)).to(cuda_device)
        before = kernels.LUT_GATHER_ROWS.launches
        got = gather.lut_gather_rows(lut, idx)
        torch.cuda.synchronize()
        assert kernels.LUT_GATHER_ROWS.launches == before + 1
        assert torch.equal(got, gather.lut_gather_rows_plain(lut, idx))
    idx = torch.from_numpy(rng.integers(0, 128, (N, 77)).astype(np.int32)).to(cuda_device)
    got = gather.lut_gather_lanes(lut, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.lut_gather_lanes_plain(lut, idx))


K4_SHAPES = [(N, C) for N in (1, 7, 8, 400, 401, 512, 4096, 16383, 16384)
             for C in (1, 100, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,C", K4_SHAPES)
def test_lut_gather_rows_every_route_matches_plain(cuda_device, N, C):
    """K4 by each route that takes the shape (staged where the LUT fits a
    block, the cache route everywhere), M != N, and on idx and out that
    are not 16-byte aligned; each launch counted by its route."""
    rng = np.random.default_rng(N * 3 + C)
    M = N + 37 if N < 4096 else N // 3
    lut = torch.from_numpy(rng.integers(-2**31, 2**31, (N, C)).astype(np.int32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, N, (M, C)).astype(np.int32)).to(cuda_device)
    idx[0] = N - 1
    want = gather.lut_gather_rows_plain(lut, idx)
    flat = torch.empty(M * C + 1, dtype=torch.int32, device=cuda_device)
    shifted = flat[1:].view(M, C)  # 4 bytes past an aligned allocation
    shifted.copy_(idx)
    routes = ["ldg"] + (["smem"] if N * C * 4 <= gather._SMEM_BYTES else [])
    for route in routes:
        before = kernels.LUT_GATHER_ROWS.by_route.get(route, 0)
        for x in (idx, shifted):
            got = gather._lut_gather_rows_cuda(lut, x, route)
            torch.cuda.synchronize()
            assert torch.equal(got, want), route
        assert kernels.LUT_GATHER_ROWS.by_route[route] == before + 2
    assert torch.equal(gather.lut_gather_rows(lut, idx), want)  # the shape's own route


K5_SHAPES = [(N, C, M) for N in (1, 7, 300, 512, 4097) for C, M in
             ((128, 128), (128, 512), (128, 77), (128, 3), (128, 1000), (1, 5), (100, 64),
              (256, 129))]


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,M", K5_SHAPES)
def test_lut_gather_lanes_every_route_matches_plain(cuda_device, N, C, M):
    """K5 by each route that takes the inputs (the register route at C =
    128 with M % 4 == 0 on 16-byte aligned tensors, the staged route
    everywhere), M != C and M % 4 != 0 included, and on a LUT and idx that
    are not 16-byte aligned; each launch counted by its route, and the
    register route refused where it does not apply."""
    rng = np.random.default_rng(N * 7 + C + M)
    lut = torch.from_numpy(rng.integers(-2**31, 2**31, (N, C)).astype(np.int32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, C, (N, M)).astype(np.int32)).to(cuda_device)
    idx[0, 0], idx[-1, -1] = C - 1, 0
    want = gather.lut_gather_lanes_plain(lut, idx)

    def shifted(x):  # 4 bytes past an aligned allocation
        flat = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda_device)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        return view

    takes_reg = C == gather.LANES_REG_C and M % 4 == 0
    inputs = ((lut, idx, takes_reg), (lut, shifted(idx), False), (shifted(lut), idx, False))
    for route in gather.LANES_ROUTES:
        before = kernels.LUT_GATHER_LANES.by_route.get(route, 0)
        launched = 0
        for lt, x, reg_ok in inputs:
            assert gather.lanes_variant(lt, x) == ("reg" if reg_ok else "smem")
            if route == "reg" and not reg_ok:
                with pytest.raises(ValueError, match="no 'reg' route"):
                    gather._lut_gather_lanes_cuda(lt, x, route)
                continue
            got = gather._lut_gather_lanes_cuda(lt, x, route)
            torch.cuda.synchronize()
            assert torch.equal(got, want), route
            launched += 1
        assert kernels.LUT_GATHER_LANES.by_route.get(route, 0) == before + launched
        assert launched == (int(takes_reg) if route == "reg" else 3)
    assert torch.equal(gather.lut_gather_lanes(lut, idx), want)  # the shape's own route


def _hashes(seed, shape):
    """Random int64 hashes, a third >= 2**63 as uint64, with zeros and
    repeats; plus a random mask."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-(2**63), 2**63 - 1, size=shape, dtype=np.int64)
    h[rng.random(shape) < 0.05] = 0
    flat = h.reshape(-1)
    flat[1::5] = flat[::5][: flat[1::5].size]
    return torch.from_numpy(h), torch.from_numpy(rng.random(shape) < 0.8)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [200_000_000, 10_000_000, 2**27, 1009, 1])
@pytest.mark.parametrize("binned", [None, False, True])  # by size, one atomic each, bins
def test_counter_kernels_match_plain(cuda_device, size, binned):
    hashes, mask = _hashes(size % 1000, (300, 149))
    table = torch.zeros(size, dtype=torch.int32)
    counter.counter_add_plain(table, hashes, mask)
    counter.counter_add_plain(table, hashes[:7], None)
    got = torch.zeros(size, dtype=torch.int32, device=cuda_device)
    h, m = hashes.to(cuda_device), mask.to(cuda_device)
    before = (kernels.COUNTER_ADD.launches, kernels.COUNTER_MASK.launches)
    if binned is None:
        counter.counter_add(got, h, m)
        counter.counter_add(got, h[:7], None)
    else:
        counter._counter_add_cuda(got, h, m, binned=binned)
        counter._counter_add_cuda(got, h[:7], None, binned=binned)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), table)
    assert int(table[0]) > 0  # hash 0 counts in slot 0
    for lo, hi in ((2, counter.INT32_MAX), (0, 3), (1, 1), (-5, 2**40)):
        want = counter.counter_mask(table, hashes, lo, hi)
        assert torch.equal(counter.counter_mask(got, h, lo, hi).cpu(), want), (lo, hi)
    assert (kernels.COUNTER_ADD.launches, kernels.COUNTER_MASK.launches) == (
        before[0] + 2, before[1] + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("n", [1, 3, 7, 8, 4097, 5_000_001])
def test_counter_mask_kernel_on_misaligned_views(cuda_device, offset, n):
    # a view at an odd element offset starts 8 bytes past a 16-byte boundary:
    # K7 takes its head and odd last element one by one; 5M elements take
    # several rounds of the resident grid
    size = 1009 if n < 10**6 else 200_000_000
    hashes, mask = _hashes(n % 1000 + offset, (n + 8,))
    table = torch.zeros(size, dtype=torch.int32, device=cuda_device)
    h = hashes.to(cuda_device)
    counter.counter_add_plain(table, h, mask.to(cuda_device))
    view = h[offset : offset + n]
    assert view.storage_offset() == offset and view.is_contiguous()
    for lo, hi in ((2, counter.INT32_MAX), (0, 3), (0, 1)):
        before = kernels.COUNTER_MASK.launches
        got = counter.counter_mask(table, view, lo, hi)
        torch.cuda.synchronize()
        assert kernels.COUNTER_MASK.launches == before + 1
        assert torch.equal(got, counter.counter_mask_plain(table, view, lo, hi)), (lo, hi)
    assert n < 100 or int((view == 0).sum()) > 0  # hash 0 among the long views


@pytest.mark.cuda
@pytest.mark.parametrize("size", [200_000_000, 10_000_000, 2**27, 1009, 7])
@pytest.mark.parametrize("ks", [(12,), (16, 18), (5, 200, 33)])  # k = 200 > L: no windows
def test_counter_add_kernel_derives_the_window_mask(cuda_device, size, ks):
    L = 160
    rng = np.random.default_rng(size % 1000 + len(ks))
    lens = torch.from_numpy(rng.integers(0, L + 1, 1200).astype(np.int32))
    lens[:4] = torch.tensor([0, 3, 17, L])  # reads shorter than k, and a full one
    hashes, _ = _hashes(len(ks), (1200, sum(max(L - k + 1, 0) for k in ks)))
    want = torch.zeros(size, dtype=torch.int32)
    for _ in range(2):  # two calls into one table
        counter.counter_add_plain(want, hashes, window_mask(lens, L, ks))
    h, ln = hashes.to(cuda_device), lens.to(cuda_device)
    for binned in (False, True):
        got = torch.zeros(size, dtype=torch.int32, device=cuda_device)
        counter._counter_add_cuda(got, h, None, (ln, L, ks), binned=binned)
        counter._counter_add_cuda(got, h, None, (ln, L, ks), binned=binned)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (size, ks, binned)
    got = counter.HashCounter(size, cuda_device).add_windows(h, ln, L, ks).add_windows(
        h, ln, L, ks).table
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < 2 * hashes.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one value", "mostly zeros", "two bins", "nine k values"])
def test_counter_add_kernel_skewed_inputs(cuda_device, case):
    # lists that overflow (what does not fit is added directly), the set of
    # one bin flushed early, and more k values than the kernel derives a
    # mask for (the wrapper then builds the mask tensor)
    size = 200_000_000
    hashes, mask = _hashes(len(case), (2000, 149))
    windows = None
    if case == "one value":
        hashes[:] = -(2**63) + 12345      # a poly-A input: every add into one slot
    elif case == "mostly zeros":
        hashes[torch.from_numpy(np.random.default_rng(2).random(hashes.shape) < 0.9)] = 0
    elif case == "two bins":               # 298,000 distinct slots in two bins
        hashes = torch.arange(hashes.numel()).reshape(hashes.shape) % 149_000 + (
            torch.arange(hashes.numel()).reshape(hashes.shape) % 2) * 100_000_000
    else:
        ks = (152, 153, 154, 155, 156, 157, 158, 159, 160)
        hashes, mask = hashes[:, : sum(160 - k + 1 for k in ks)].contiguous(), None
        windows = (torch.from_numpy(np.random.default_rng(1).integers(0, 161, 2000)), 160, ks)
    want = torch.zeros(size, dtype=torch.int32, device=cuda_device)
    h = hashes.to(cuda_device)
    m = None if mask is None else mask.to(cuda_device)
    plain_mask = m if windows is None else window_mask(windows[0].to(cuda_device), *windows[1:])
    counter.counter_add_plain(want, h, plain_mask)
    if windows is not None:
        windows = (windows[0].to(cuda_device), *windows[1:])
    for binned in (False, True):
        got = torch.zeros(size, dtype=torch.int32, device=cuda_device)
        counter._counter_add_cuda(got, h, m, windows, binned=binned)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (case, binned)
    assert int(want.max()) > (1000 if case in ("one value", "mostly zeros") else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("copies,binned", [(1, False), (6, True)])
def test_hash_counter_reads_its_route_from_the_first_binned_call(cuda_device, copies, binned):
    L, k, B = 160, 12, 1200
    rng = np.random.default_rng(copies)
    distinct = rng.integers(1, 2**63, size=B * (L - k + 1) // copies, dtype=np.int64)
    hashes = torch.from_numpy(rng.permutation(np.tile(distinct, copies))).reshape(B, -1)
    lens = torch.from_numpy(rng.integers(0, L + 1, B).astype(np.int32))
    small = hashes[:5].contiguous()  # under BINNED_MIN_N: one atomic each, no reading
    assert small.numel() < counter.BINNED_MIN_N <= hashes.numel()
    want = torch.zeros(200_000_000, dtype=torch.int32, device=cuda_device)
    h, ln, sm = hashes.to(cuda_device), lens.to(cuda_device), small.to(cuda_device)
    for _ in range(3):
        counter.counter_add_plain(want, h, window_mask(ln, L, [k]))
    counter.counter_add_plain(want, sm, window_mask(ln[:5], L, [k]))
    c = counter.HashCounter(200_000_000, cuda_device)
    c.add_windows(sm, ln[:5], L, k)
    assert c.binned is None
    before = kernels.COUNTER_ADD.launches
    for _ in range(3):
        c.add_windows(h, ln, L, k)
        assert c.binned is binned
    torch.cuda.synchronize()
    assert torch.equal(c.table, want) and kernels.COUNTER_ADD.launches == before + 3


@pytest.mark.cuda
def test_counter_add_kernel_reports_what_the_merge_did(cuda_device):
    rng = np.random.default_rng(8)
    distinct = torch.from_numpy(rng.integers(1, 2**63, size=300_000, dtype=np.int64))
    hashes = distinct.repeat(4).reshape(1200, 1000).to(cuda_device)  # four copies of each
    table = torch.zeros(10_000_000, dtype=torch.int32, device=cuda_device)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    assert counter._counter_add_cuda(table, hashes, None, stats=stats)
    adds, elements = stats.tolist()
    slots = int(torch.unique(counter.slots(distinct, 10_000_000)).numel())
    # a slot's copies meet in one bin, whose set holds them all: one add a slot
    assert (adds, elements) == (slots, 1_200_000) and 290_000 < slots <= 300_000
    assert int(table.sum()) == 1_200_000 and int(table.max()) >= 4
    assert not counter._counter_add_cuda(table, hashes[:1], None, stats=stats)
    assert stats.tolist() == [adds, elements]  # one atomic per element reports nothing


@pytest.mark.cuda
def test_counter_kernels_skip_empty_inputs(cuda_device):
    table = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    empty = torch.zeros((3, 0), dtype=torch.int64, device=cuda_device)
    before = kernels.launch_counts()
    counter.counter_add(table, empty, torch.zeros((3, 0), dtype=torch.bool, device=cuda_device))
    assert counter.counter_mask(table, empty, 0, 1).shape == (3, 0)
    assert kernels.launch_counts() == before and int(table.sum()) == 0


def _map_and_queries(seed: int, n_keys: int):
    """A depth map holding key 0, keys >= 2**63, random keys and counts
    past a word (the overflow), and queries: every key, and as many
    misses."""
    rng = np.random.default_rng(seed)
    keys = np.unique(np.concatenate([
        np.array([0, 2**63, 2**64 - 1, 0x80000001_7FFFFFFF, 0x80000000], dtype=np.uint64),
        rng.integers(0, 2**64 - 1, size=n_keys, dtype=np.uint64, endpoint=True)]))
    vals = rng.integers(1, 2000, size=len(keys)).astype(np.int32)
    vals[::13] = 2**31 - 1
    sm = hashmap.build_sorted_map(keys, vals)
    miss = rng.integers(0, 2**64 - 1, size=len(keys), dtype=np.uint64, endpoint=True)
    q = np.concatenate([keys, miss])[rng.permutation(2 * len(keys))]
    return sm, torch.from_numpy(q.view(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", [1, 1000, 300_000])
def test_hashmap_kernel_matches_plain(cuda_device, n_keys):
    sm, q = _map_and_queries(n_keys, n_keys)
    assert sm.m > 0
    want = hashmap.hashmap_get_plain(sm, q)
    t, qd = sm.to(cuda_device), q.to(cuda_device)
    before = kernels.HASHMAP_GET.launches
    got = hashmap.hashmap_get(t, qd)
    torch.cuda.synchronize()
    assert kernels.HASHMAP_GET.launches == before + 1
    assert torch.equal(got.cpu(), want) and int((want != 0).sum()) >= n_keys
    grid = qd[: (qd.numel() // 7) * 7].reshape(7, -1)  # shapes pass through
    assert torch.equal(hashmap.hashmap_get(t, grid).cpu(), want[: grid.numel()].reshape(7, -1))
    assert hashmap.hashmap_get(t, qd[:0]).shape == (0,)
    assert kernels.HASHMAP_GET.launches == before + 2  # no launch for no keys


@pytest.mark.cuda
def test_hashmap_kernel_on_an_empty_map_and_a_cpu_map(cuda_device):
    empty = hashmap.depth_map_from_hashes(np.zeros(0, np.int64)).to(cuda_device)
    q = torch.tensor([0, 1, -1], dtype=torch.int64, device=cuda_device)
    assert torch.equal(hashmap.hashmap_get(empty, q).cpu(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="on the map's device"):
        hashmap.hashmap_get(empty.to("cpu"), q)


@pytest.mark.cuda
@pytest.mark.parametrize("case,seed", [(c, s) for c in map_cases.CASES
                                       for s in ((0, 1, 2) if c == "duplicates" else (0,))])
def test_device_map_build_matches_numpy_build(cuda_device, case, seed):
    """call's depth map built on the card (``torch.unique`` and the layout
    in torch ops) equals the numpy build's buffer element for element,
    sorted whole and in groups whose keys and counts are merged."""
    h = map_cases.hash_case(case, seed)
    want = hashmap.build_sorted_map(*hashmap.unique_counts(h))
    on_card = torch.from_numpy(h).to(cuda_device)
    for group in (hashmap.UNIQUE_GROUP, 1000):
        got = hashmap.layout_sorted_map(*hashmap.unique_counts_torch(on_card, group=group))
        assert got.device.type == "cuda"
        assert (got.bits, got.n, got.m) == (want.bits, want.n, want.m)
        assert torch.equal(got.buf.cpu(), want.buf)


@pytest.mark.cuda
def test_build_depth_map_on_the_card_matches_numpy_build(cuda_device, tmp_path):
    """call's depth map on the card, no hash fetched: the numpy build's map
    of the reads' hashes (made on the CPU) byte for byte."""
    _, reads_path, _, _ = synth.write_call_workload(str(tmp_path), n_reads=200, seed=7)
    reads = load_packed([reads_path])
    stats = {}
    got = call_cmd.build_depth_map(reads, (16,), 64, cuda_device, stats)
    want = map_cases.reads_depth_map(reads, (16,))
    assert stats["map_hashes_sorted_on_device"] == \
        int(np.maximum(reads.lens.astype(np.int64) - 15, 0).sum())
    assert got.device.type == "cuda"
    assert (got.bits, got.n, got.m) == (want.bits, want.n, want.m)
    assert torch.equal(got.buf.cpu(), want.buf)


def _call_case(k: int, seed: int = 5):
    """A reference with runs of N, and the depth map of reads of a sample
    with a substitution and a deletion, some reads with N."""
    rng = np.random.default_rng(seed + k)
    ref = rng.integers(0, 4, 1500).astype(np.uint8)
    ref[200:230] = 4
    ref[900] = 4
    sample = ref.copy()
    sample[600] = (sample[600] + 1) % 4
    sample = np.delete(sample, 1100)
    starts = rng.integers(0, len(sample) - 150, 300)
    reads = sample[starts[:, None] + np.arange(150)]
    reads[rng.random(reads.shape) < 0.005] = 4
    h = kmer_window_hashes_plain(torch.from_numpy(reads), k)
    return torch.from_numpy(ref), hashmap.depth_map_from_hashes(h.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 12, 16, 21, 31, 32, 33, 40])
@pytest.mark.parametrize("w", [1, 100, 5000])
def test_call_scan_kernel_matches_plain(cuda_device, k, w):
    ref, table = _call_case(k)
    want = call_engine.call_scan_plain(ref, table, k, w)
    before = kernels.launch_counts()
    routes = dict(kernels.CALL_SCAN.by_route)
    got = call_engine.call_scan_ref(ref.to(cuda_device), table.to(cuda_device), k, w)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert [after[n] - before[n] for n in ("window_hash", "hashmap_get", "call_scan")] == [1, 1, 1]
    route = "packed" if k <= 32 else "bytewise"
    assert kernels.CALL_SCAN.by_route[route] == routes.get(route, 0) + 1
    for name, v in want.items():
        assert got[name].dtype == v.dtype and torch.equal(got[name].cpu(), v), name
    if w == 100 and k >= 12:
        assert bool(want["site"].any()) and bool(want["snp_call"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 32])
def test_call_scan_bytewise_route_matches_plain(cuda_device, k):
    """The byte-wise route, asked for at k <= 32, gives the packed route's
    outputs and the plain version's."""
    ref, table = _call_case(k, seed=9)
    want = call_engine.call_scan_plain(ref, table, k, 100)
    r, t = ref.to(cuda_device), table.to(cuda_device)
    args = (r, t, k, want["depth"].to(cuda_device), want["avg"].to(cuda_device),
            want["site"].to(cuda_device))
    names = ("snp_depth", "snp_call", "max_rescue", "del_depth", "del_call")
    for route in (None, "bytewise"):
        for name, got in zip(names, call_engine._call_scan_cuda(*args, route)):
            assert torch.equal(got.cpu(), want[name]), (route, name)
    with pytest.raises(ValueError, match="no route"):
        call_engine._call_scan_cuda(*args, "packed")


@pytest.mark.cuda
def test_call_scan_kernel_on_split_positional_rows(cuda_device):
    ref, table = _call_case(16)
    row = ref.to(cuda_device)
    assert torch.equal(call_engine.positional_hashes(row, 16, row_windows=128).cpu(),
                       kmer_window_hashes_plain(ref[None], 16)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("R", [PAST + 1, 9000, 12288])
def test_panel_probe_wide_kernel_matches_plain(cuda_device, R):
    """K11 on its packed table (made on the host, copied alone), both row
    modes and both epilogues, on ties and maxima on both sides of
    reference 8,192 and duplicate-heavy rows."""
    ref_sk, ref_lens, reads, set_lens = straddling_panel(R, seed=R, n_reads=99)
    table = torch.from_numpy(build_panel_table(ref_sk, ref_lens).table.view(np.int32))
    wide = device_table(table, R, cuda_device)
    assert isinstance(wide, WideTable) and wide.device.type == "cuda"
    table, raw = table.to(cuda_device), torch.from_numpy(reads).to(cuda_device)
    set_lens = torch.from_numpy(set_lens).to(cuda_device)
    sk, lens = bottom_s_sketch(raw, 32)
    before = dict(kernels.PANEL_PROBE_WIDE.by_route)
    for rows, ln in ((raw, None), (sk, lens)):
        for md, mm in ((0, -1), (1, 9)):
            got = panel_probe(rows, ln, wide, R, md, mm)
            torch.cuda.synchronize()
            want = panel_probe_plain(rows, ln, table, R, md, mm)
            assert torch.equal(got, want), (R, ln is None, md, mm)
            assert torch.equal(want, panel_probe_wide_packed_plain(rows, ln, wide, R, md, mm))
            got = panel_probe_filter(rows, ln, wide, R, set_lens, md, mm)
            assert torch.equal(got, panel_probe_filter_plain(rows, ln, table, R, set_lens, md,
                                                             mm)), (R, ln is None, md, mm)
    assert kernels.PANEL_PROBE_WIDE.by_route["stream"] == before.get("stream", 0) + 4
    assert want[0, :3].tolist() == [100, PAST, PAST - 2]


@pytest.mark.cuda
@pytest.mark.parametrize("R,width", [(8192, 149), (300, 256), (60, 7000), (1, 64)])
def test_panel_probe_wide_kernel_equals_k2(cuda_device, R, width):
    """At R <= 8,192 both kernels take the panel: K11 on the packed table
    must give K2's bits on the logical one."""
    table, raw = _panel(R + 3 * width, R, 64, 99, width)
    table, raw = table.to(cuda_device), raw.to(cuda_device)
    wide = pack_wide_table(table, R)
    ref_lens = torch.arange(R, dtype=torch.int32, device=cuda_device) % 70
    sk, lens = bottom_s_sketch(raw, width if width > 1000 else width // 2)
    for rows, ln in [(sk, lens)] + ([(raw, None)] if width <= 256 else []):
        k2 = _panel_probe_cuda(rows, ln, table, R, 1, 3, wide=False)
        k2_f = _panel_probe_filter_cuda(rows, ln, table, R, ref_lens, 1, 3, wide=False)
        got = _panel_probe_cuda(rows, ln, wide, R, 1, 3, wide=True)
        got_f = _panel_probe_filter_cuda(rows, ln, wide, R, ref_lens, 1, 3, wide=True)
        assert torch.equal(got, k2) and torch.equal(got_f, k2_f), (R, width)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_panel_probe_wide_kernel_on_one_entry_and_8193_refs(cuda_device):
    """K11 on a WideTable with one occupied slot, and at R = 8,193 (Wm =
    257, not a multiple of 4) on many hits a read (every count plane)."""
    R = PAST + 1
    one = np.full((R, 1), SENTINEL, dtype=np.int64)
    one[R - 1, 0] = 12345
    table = torch.from_numpy(build_panel_table(one, (one[:, 0] != SENTINEL).astype(np.int32))
                             .table.view(np.int32))
    wide = pack_wide_table(table, R).to(cuda_device)
    assert wide.rows.shape[0] == 1
    raw = torch.tensor([[12345, 0, 7], [1, 2, 3], [12345, 12345, 5]], dtype=torch.int64)
    for rows, ln in ((raw, None), bottom_s_sketch(raw, 3)):
        want = panel_probe_plain(rows, ln, table, R, 0, -1)
        got = panel_probe(rows.to(cuda_device), None if ln is None else ln.to(cuda_device),
                          wide, R, 0, -1)
        assert torch.equal(got.cpu(), want)
    assert want[:2, 0].tolist() == [R - 1, 1]
    rng = np.random.default_rng(8193)
    pool = rng.integers(1, 2**63, size=600, dtype=np.int64)
    sk = np.sort(rng.choice(pool, (R, 40)).view(np.uint64), axis=1).view(np.int64)
    table = torch.from_numpy(build_panel_table(sk, np.full(R, 40, np.int32)).table.view(np.int32))
    wide = device_table(table, R, cuda_device)
    reads = torch.from_numpy(rng.choice(pool, (16, 1200)))  # values repeat: ranks > 0
    for rows, ln in ((reads[:, :12], None), (reads[:, :250], None),
                     bottom_s_sketch(reads, 1200)):  # < 16, < 256 and >= 256 hits a read
        want = panel_probe_plain(rows, ln, table, R, 1, 3)
        got = panel_probe(rows.to(cuda_device), None if ln is None else ln.to(cuda_device),
                          wide, R, 1, 3)
        assert torch.equal(got.cpu(), want), rows.shape


def _sorted_panel(rows, R, device):
    return convert.sorted_panel_from_numpy(*lookup.build_sorted_panel(rows, num_refs=R), device)


@pytest.mark.cuda
@pytest.mark.parametrize("T,U,width", [(1, 0, 64), (30, 10, 500), (182, 14, 4000),
                                       (300, 40, 256)])
def test_sorted_probe_kernel_matches_plain(cuda_device, T, U, width):
    """K10 against its plain version and against K3's on the same sets."""
    table, pool, rows, rng = _set_table(T + width, T, U, 96)
    full, lens = _sorted_rows(rng, pool, 64, width)
    full[3] = full[3, 0]  # a row of one repeated value
    lens[3] = width
    full[5:8], lens[5:8] = SENTINEL, 0  # reads with no valid element (-M zeroed them all)
    panel = _sorted_panel(rows, T + U, cuda_device)
    assert (panel.keys.cpu() >= 0).any() and (panel.keys.cpu() < 0).any()  # keys >= 2**63 too
    full, lens = full.to(cuda_device), lens.to(cuda_device)
    before = kernels.SORTED_PROBE.launches
    for n in (width, width // 2):
        for seg in (32, 2048):
            got = _sorted_probe_cuda(full[:, :n], lens, panel, T, U, seg=seg)
            torch.cuda.synchronize()
            want = sorted_probe_plain(full[:, :n], lens, panel, T, U)
            assert torch.equal(got, want), (T, U, width, n, seg)
        assert torch.equal(want, set_probe_plain(full[:, :n], lens, table.to(cuda_device), T, U))
    want = sorted_probe_plain(full, lens, panel, T, U)
    assert torch.equal(sorted_probe(full, lens, panel, T, U), want)  # the wrapper's route
    assert kernels.SORTED_PROBE.launches == before + 5
    assert int(want[:, 1].max()) > 1 and (want[5:8] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one-bucket", "U1", "empty-buckets"])
def test_sorted_probe_kernel_on_edge_directories(cuda_device, case):
    """K10 on one bucket holding every key (the binary search inside it),
    one key, and empty buckets on both sides of 2**63."""
    rng = np.random.default_rng(len(case))
    if case == "one-bucket":  # 3,000 keys sharing their top 20 bits
        keys = (np.uint64(0xABCDE) << np.uint64(44)) | rng.integers(
            0, 2**44, 3000, dtype=np.uint64)
    elif case == "U1":
        keys = np.array([2**63 + 5], dtype=np.uint64)
    else:  # keys just below and above 2**63 only: every other bucket is empty
        keys = np.concatenate([2**63 - 1 - rng.integers(0, 2**40, 300, dtype=np.uint64),
                               2**63 + rng.integers(0, 2**40, 300, dtype=np.uint64)])
    keys = np.unique(keys)
    rows = [rng.choice(keys, max(1, keys.size // 2)) for _ in range(40)]
    panel = _sorted_panel(rows, 40, cuda_device)
    sizes = panel.dir.diff().cpu()
    mid = sizes.numel() // 2
    assert int(panel.dir[-1]) == keys.size
    if case == "one-bucket":
        assert int((sizes > 0).sum()) == 1 and int(sizes.max()) == keys.size
    elif case == "empty-buckets":  # only the two buckets beside 2**63 hold keys
        assert int(sizes[mid - 1]) > 0 and int(sizes[mid]) > 0
        assert int((sizes > 0).sum()) == 2
    strangers = rng.integers(1, 2**64 - 1, 200, dtype=np.uint64)
    raw = np.concatenate([rng.choice(keys, (24, 60)), rng.choice(strangers, (24, 60))], axis=1)
    full, lens = bottom_s_sketch(torch.from_numpy(raw.view(np.int64)), 120)
    cpu = _sorted_panel(rows, 40, "cpu")
    want = sorted_probe_plain(full, lens, cpu, 30, 10)
    assert torch.equal(want, sorted_probe_plain_dir(full, lens, cpu, 30, 10))
    got = _sorted_probe_cuda(full.to(cuda_device), lens.to(cuda_device), panel, 30, 10, seg=32)
    assert torch.equal(got.cpu(), want) and int(want[:, 1].max()) > 0


@pytest.mark.cuda
def test_sorted_probe_kernel_takes_a_40kb_read_and_one_key(cuda_device):
    _, pool, rows, rng = _set_table(40, 182, 14, 2000)
    full, lens = _sorted_rows(rng, pool, 2, 40_000)
    panel = _sorted_panel(rows, 196, cuda_device)
    got = sorted_probe(full.to(cuda_device), lens.to(cuda_device), panel, 182, 14)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sorted_probe_plain(full, lens, _sorted_panel(rows, 196, "cpu"),
                                                     182, 14))
    assert int(got[:, 1].min()) > 100
    one = _sorted_panel([pool[:1]], 1, cuda_device)  # R = 1, one key
    x = torch.from_numpy(np.sort(pool[:40].view(np.uint64)).view(np.int64))[None].to(cuda_device)
    ln = torch.tensor([40], dtype=torch.int32, device=cuda_device)
    assert sorted_probe(x, ln, one, 1, 0).tolist() == [[0, 1]]


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,C", [(180, 10, 1), (180, 10, 5), (180, 110, 11),
                                   (4096, 1002, 10), (333, 65, 4), (50, 40, 16), (50, 40, 17)])
def test_sparse_margin_kernel_matches_plain(cuda_device, N, F, C):
    """K12 forward and backward at the pipeline's shapes (vwize's 10 and
    vv's 110 features, 1 / 5 / 11 classes), hash -w's per-read shape and
    the class-tile edges (4, 16, 17); the backward twice, equal bits."""
    before = (kernels.SPARSE_MARGIN.launches, kernels.SPARSE_MARGIN_GRAD.launches)
    check_margins(*margin_case(N, F, C, 18, N + F + C, cuda_device))
    assert (kernels.SPARSE_MARGIN.launches, kernels.SPARSE_MARGIN_GRAD.launches) == \
        (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
def test_sparse_margin_kernel_edge_cases(cuda_device):
    for name, case in edge_cases(cuda_device).items():
        check_margins(*case)
    W, idx, val, _ = edge_cases(cuda_device)["all padding"]
    assert int(sparse_margins(W, idx, val).abs().sum()) == 0


@pytest.mark.cuda
def test_sparse_margins_autograd_on_the_card(cuda_device):
    """sparse_margins on CUDA tensors is K12 under autograd: a loss's
    gradient through it equals the plain version's within the tolerance,
    and the step launches both kernels once."""
    W, idx, val, dm = margin_case(300, 50, 5, 12, 9, cuda_device)
    Wk = W.clone().requires_grad_(True)
    Wp = W.clone().requires_grad_(True)
    before = (kernels.SPARSE_MARGIN.launches, kernels.SPARSE_MARGIN_GRAD.launches)
    (sparse_margins(Wk, idx, val) * dm).sum().backward()
    (sparse_margins_plain(Wp, idx, val) * dm).sum().backward()
    torch.cuda.synchronize()
    assert (kernels.SPARSE_MARGIN.launches, kernels.SPARSE_MARGIN_GRAD.launches) == \
        (before[0] + 1, before[1] + 1)
    bound = torch.zeros_like(W).index_add_(
        1, idx.long().reshape(-1), (val.abs()[None] * dm.abs()[:, :, None]).reshape(5, -1))
    assert bool(((Wk.grad - Wp.grad).abs() <= 1e-5 * bound + 1e-6).all())
    with pytest.raises(ValueError, match="int32"):
        sparse_margins(W, idx.long(), val)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one slot", "edges"])
def test_sparse_margin_backward_repeats_its_bits(cuda_device, name):
    """K12's backward has no atomics: five runs on the same inputs, one of
    them over a plan built anew, give the same bits (131,072 entries on
    one slot: one run across 512 chunks, joined by the second pass)."""
    W, idx, val, dm = edge_cases(cuda_device)[name]
    grads = [_margins_grad_cuda(dm, build_plan(idx, val, W.shape[1]))]
    plan = build_plan(idx, val, W.shape[1])
    grads += [_margins_grad_cuda(dm, plan) for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, grads[0]) for g in grads[1:])


@pytest.mark.cuda
def test_sparse_margins_with_and_without_a_prebuilt_plan(cuda_device):
    """The trainer's form with its plan, the same form building the plan in
    its backward, and the [C, D] form: the same gradient bits, one launch
    of each kernel a step; the padding's gradient 0."""
    W, idx, val, dm = margin_case(400, 90, 10, 16, 11, cuda_device)
    grads = []
    before = (kernels.SPARSE_MARGIN.launches, kernels.SPARSE_MARGIN_GRAD.launches)
    for plan in (build_plan(idx, val, W.shape[1]), None):
        Wp = pack_weights(W).requires_grad_(True)
        (sparse_margins_packed(Wp, idx, val, 10, plan) * dm).sum().backward()
        grads.append(Wp.grad)
    Wc = W.clone().requires_grad_(True)
    (sparse_margins(Wc, idx, val) * dm).sum().backward()
    torch.cuda.synchronize()
    assert (kernels.SPARSE_MARGIN.launches, kernels.SPARSE_MARGIN_GRAD.launches) == \
        (before[0] + 3, before[1] + 3)
    assert torch.equal(grads[0], grads[1]) and torch.equal(unpack_weights(grads[0], 10), Wc.grad)
    assert grads[0].shape == (1 << 16, 12) and not grads[0][:, 10:].any()


@pytest.mark.cuda
def test_sparse_margin_grad_refuses_a_chunk_it_cannot_take(cuda_device):
    W, idx, val, dm = margin_case(50, 40, 3, 12, 5, cuda_device)
    with pytest.raises(RuntimeError, match="rkmh_sparse_margin_grad"):
        _margins_grad_cuda(dm, build_plan(idx, val, W.shape[1], chunk=100))


@pytest.mark.cuda
def test_training_on_the_card_repeats_its_bits(cuda_device):
    """Two --ect trainings on the card: weights equal bit for bit."""
    from rkmh_tpu_torch.ml.wabbit import train_multiclass

    rng = np.random.default_rng(14)
    idx = rng.integers(0, 1 << 14, size=(300, 60)).astype(np.int32)
    idx[:, :2] = [11, 12]  # constant features: their gradient cancels to ~0
    val = rng.standard_normal((300, 60)).astype(np.float32)
    val[:, :2] = 1.0
    y = rng.integers(1, 11, size=300)
    runs = [train_multiclass(idx, val, y, 10, 14, 25, 0.05, device=cuda_device)
            for _ in range(2)]
    assert runs[0].shape == (10, 1 << 14) and runs[0].tobytes() == runs[1].tobytes()


def test_library_is_keyed_by_sources_and_flags(monkeypatch):
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path == kernels.library_path()
    assert {p.name for p in kernels.sources()} == {"window_hash.cu", "panel_probe.cu",
                                                   "set_probe.cu", "lut_gather.cu",
                                                   "counter.cu", "hashmap.cu", "call_scan.cu",
                                                   "sparse_margin.cu", "set_table.cu"}
    assert {p.name for p in kernels.headers()} == {"murmur3.cuh", "hashmap.cuh",
                                                   "packed_kmer.cuh"}
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path() != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_launch_counts_reset():
    kernels.WINDOW_HASH.launches = 3
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"window_hash": 0, "panel_probe": 0,
                                       "panel_probe_filter": 0, "panel_probe_wide": 0,
                                       "panel_probe_partial": 0,
                                       "set_probe": 0, "set_probe_partial": 0,
                                       "sorted_probe": 0,
                                       "lut_gather_rows": 0, "lut_gather_lanes": 0,
                                       "counter_add": 0, "counter_mask": 0,
                                       "hashmap_get": 0, "call_scan": 0,
                                       "set_table_fill": 0,
                                       "sparse_margin": 0, "sparse_margin_grad": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("R,nb,slots", [(1, None, None), (33, None, None), (70, 16, 2),
                                        (200, None, None)])
def test_set_table_fill_kernel_matches_plain_and_builds(cuda_device, R, nb, slots):
    """K13 against ``set_table_fill_plain`` on the same sorted entries (the
    fitting geometry, and a forced small one that overflows), every lane and
    max_rank; then the device builds on the card against the same builds on
    the CPU, bit for bit, for a set table and a sketch-panel table."""
    rng = np.random.default_rng(R)
    pool = rng.integers(1, 2**63, size=60 * R, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    h = torch.from_numpy(rng.choice(pool, (R, 120)))
    h[:, ::13] = 0
    m = torch.from_numpy(rng.random((R, 120)) < 0.9)
    entries = lookup._unique_entries(h, m, R)
    n = entries[0].numel()
    S = slots or lookup.pick_slots(n, (R + 31) // 32, policy="compact")
    nb = nb or lookup.predicted_buckets(n, S)
    inputs = lookup.fill_inputs(entries, nb, False)
    want, want_rank = lookup.set_table_fill_plain(*inputs, nb, S)
    before = kernels.SET_TABLE_FILL.launches
    got, rank = lookup.set_table_fill(*(t.to(cuda_device) for t in inputs), nb, S)
    torch.cuda.synchronize()
    assert kernels.SET_TABLE_FILL.launches == before + 1
    assert torch.equal(got.cpu(), want) and int(rank) == int(want_rank)
    assert (int(rank) >= S) == (slots is not None)
    on_card = lookup.build_set_table_device(h.to(cuda_device), m.to(cuda_device), R)
    assert torch.equal(on_card.cpu(), lookup.build_set_table_device(h, m, R))
    sk, lens = bottom_s_sketch(torch.where(m, h, 0), 100)
    assert torch.equal(lookup.build_panel_table_device(sk.to(cuda_device), lens.to(cuda_device))
                       .cpu(), lookup.build_panel_table_device(sk, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("crowd", [True, False], ids=["crowded", "fits"])
@pytest.mark.parametrize("geometry", [*fill_cases.GEOMETRIES, fill_cases.WIDE],
                         ids=lambda g: f"S{g[0]}-Wm{g[1]}")
def test_set_table_fill_kernel_tile_geometries(cuda_device, geometry, crowd):
    """K13 against ``set_table_fill_plain`` at the geometries of its tiles
    (``bench/fill_cases``): 1,029 buckets (a partial last tile), 64 k + 5
    buckets at S = 2 and 12, no entries, and rows cut into windows; every
    lane and max_rank."""
    S, Wm = geometry
    nbs = [7] if geometry == fill_cases.WIDE else [fill_cases.NB] + (
        [64 * 1024 + 5] if S in (2, 12) and Wm < 64 else [])
    for nb in nbs:
        for n in (None, 0):
            inputs = [torch.from_numpy(a) for a in fill_cases.fill_case(S, Wm, nb, n, seed=20,
                                                                         crowd=crowd)]
            want, want_rank = lookup.set_table_fill_plain(*inputs, nb, S)
            got, rank = lookup.set_table_fill(*(t.to(cuda_device) for t in inputs), nb, S)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want) and int(rank) == int(want_rank), (nb, n)
            assert (int(rank) >= S) == (crowd and n is None), (nb, n, int(rank))


@pytest.mark.cuda
@pytest.mark.parametrize("R,slots", [(30, 2), (15, 2), (40, 2), (60, 2), (200, 2), (30, 3),
                                     (60, 5)])
def test_panel_probe_kernel_narrow_slot_routes(cuda_device, R, slots):
    """K2's S = 2 route (the whole 32-byte row at Wm = 1, pairs at Wm = 2
    and 7) and the lane-by-lane route of odd S, in all three epilogues,
    against the plain versions: raw and sorted rows, several -D/-N."""
    sk, lens, reads, set_lens = _sketches(R + slots, R)
    table = torch.from_numpy(build_panel_table(sk, lens, slots=slots).table.view(np.int32))
    assert lookup.table_slots(table.shape[1], R) == slots
    table = table.to(cuda_device)
    raw = torch.from_numpy(reads).to(cuda_device)
    set_lens = torch.from_numpy(set_lens).to(cuda_device)
    sk_rows, sk_lens = bottom_s_sketch(raw, 32)
    for rows, ln in ((raw, None), (sk_rows, sk_lens)):
        for md, mm in ((0, -1), (1, 3)):
            got = panel_probe(rows, ln, table, R, md, mm)
            torch.cuda.synchronize()
            want = panel_probe_plain(rows, ln, table, R, md, mm)
            assert torch.equal(got, want), (R, slots, ln is None, md, mm)
            assert torch.equal(panel_probe_filter(rows, ln, table, R, set_lens, md, mm),
                               panel_probe_filter_plain(rows, ln, table, R, set_lens, md, mm))
        for init in (-1, 0):
            assert torch.equal(panel_probe_partial(rows, ln, table, R, init),
                               panel_probe_partial_plain(rows, ln, table, R, init))
    assert int(want[1].max()) > 0
