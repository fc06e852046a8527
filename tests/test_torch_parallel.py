"""The port's --devices / --tp machinery (``rkmh_tpu_torch/parallel/``)
against rkmh-tpu's ``parallel/`` on the CPU.

rkmh-tpu runs on the 8 virtual CPU devices tests/conftest.py gives JAX;
the port on grids of ``cpu`` entries, where every kernel is its plain
version.  Inputs are made from seeds with numpy.  Every comparison is
exact (integer counts, flags and table bits):

* ``merge_tp_partials`` of the shards' plain partials equals
  ``argmax_stream`` / ``argmax_filter`` on the whole counts (hypothesis:
  ties across shards, all-zero rows, tp from 1 to 8);
* ``build_sharded_tables`` gives rkmh-tpu's table bits at tp 1, 2 and 4;
* on shards of rkmh-tpu's S = 2 geometry (30 and 40 references a shard:
  one and two mask words), the stream, filter and partial plain probes
  equal rkmh-tpu's counts and argmax, raw and sorted rows;
* the sharded classify and filter steps equal ``sharded_classify_table_fn``
  / ``sharded_filter_table_fn`` at (dp, tp) = (4, 1), (2, 2) and (1, 4),
  with and without the -M counter;
* the dp-sharded counter equals rkmh-tpu's ``sharded_counter_add_codes_fn``
  (through ``convert``) and one device's counter, and the range forms of
  the counter's plain add and mask partition the whole table's;
* ``sp_sketch`` over 8 chunks equals rkmh-tpu's ``sp_sketch_fn`` on the 8
  virtual devices and one device's ``sketch_batch``, for one k and for
  -k 12 -k 16 (invalid codes, a chunk shorter than a k-mer's halo);
* ``ShardedSetPanel`` places each hpv16 shard once per (shard, device).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from rkmh_tpu.io.packing import encode_seqs as jax_encode
from rkmh_tpu.parallel import ep as jax_ep
from rkmh_tpu.parallel import mesh as jax_mesh
from rkmh_tpu_torch import convert
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.ops import counter
from rkmh_tpu_torch.ops.lookup import build_panel_table
from rkmh_tpu_torch.ops.probe import (
    INT32_MAX,
    pack_filter_result,
    pack_result,
    pack_wide_table,
    panel_probe_filter_plain,
    panel_probe_partial,
    panel_probe_partial_plain,
    panel_probe_plain,
    partial_from_counts,
)
from rkmh_tpu_torch.parallel.ep import ShardedCounter
from rkmh_tpu_torch.parallel.mesh import (
    ShardedPanel,
    build_sharded_tables,
    make_mesh,
    merge_tp_partials,
    sharded_classify_step,
    sharded_filter_step,
    visible_devices,
)

CPU = torch.device("cpu")
CPU_GRID = (CPU,) * 8  # as many entries as JAX's virtual devices
KS, S = (12,), 64
GEOMETRIES = [(4, 1), (2, 2), (1, 4)]


def _random_dna(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8),
                            p=[0.24, 0.24, 0.24, 0.24, 0.04], size=n))


@pytest.fixture(scope="module")
def data():
    """16 references of 1.5 kb and 96 reads of 100-128 bp, a third of them
    cut from the references (so reads share sketch elements), as codes."""
    rng = np.random.default_rng(15)
    refs = [_random_dna(rng, 1500) for _ in range(16)]
    reads = []
    for i in range(96):
        n = int(rng.integers(100, 129))
        if i % 3:
            reads.append(_random_dna(rng, n))
        else:
            r = refs[int(rng.integers(0, 16))]
            at = int(rng.integers(0, len(r) - n))
            reads.append(r[at: at + n])
    read_codes, read_lens = jax_encode(reads, pad_to=128)
    ref_codes, _ = jax_encode(refs, pad_to=1536)
    sk, lens = engine.sketch_batch(torch.from_numpy(ref_codes), KS, S)
    return {"codes": read_codes, "lens": read_lens, "sk": sk.numpy(), "sk_lens": lens.numpy()}


def _grid(dp, tp):
    return make_mesh((CPU,) * (dp * tp), dp=dp, tp=tp)


# ---- the merge


@st.composite
def _counts(draw):
    tp = draw(st.integers(1, 8))
    rps = draw(st.integers(1, 5))
    B = draw(st.integers(1, 6))
    top = draw(st.integers(0, 3))  # small counts: ties everywhere
    flat = draw(st.lists(st.integers(0, top), min_size=B * tp * rps, max_size=B * tp * rps))
    counts = torch.tensor(flat, dtype=torch.int32).reshape(B, tp * rps)
    if draw(st.booleans()):
        counts[0] = 0  # an all-zero row
    sk_lens = torch.tensor(draw(st.lists(st.integers(0, 9), min_size=B, max_size=B)),
                           dtype=torch.int32)
    ref_lens = torch.tensor(draw(st.lists(st.integers(0, 9), min_size=tp * rps,
                                          max_size=tp * rps)), dtype=torch.int32)
    return tp, rps, counts, sk_lens, ref_lens, draw(st.integers(-1, 2)), draw(st.integers(-1, 4))


@settings(max_examples=300, deadline=None)
@given(_counts())
def test_merge_equals_the_argmax_on_the_whole_counts(case):
    tp, rps, counts, sk_lens, ref_lens, min_diff, min_matches = case
    for init, ref in ((-1, None), (0, ref_lens)):
        parts = torch.stack([partial_from_counts(counts[:, j * rps: (j + 1) * rps], sk_lens, init)
                             for j in range(tp)])
        got = merge_tp_partials(parts, rps, min_diff, min_matches, ref)
        if ref is None:
            want = pack_result(*engine.argmax_stream(counts, min_diff, min_matches, sk_lens))
        else:
            want = pack_filter_result(*engine.argmax_filter(counts, min_diff, min_matches,
                                                            sk_lens, ref_lens))
        assert torch.equal(got, want)


def test_merge_equals_jax_argmax_on_ties_across_shards():
    from rkmh_tpu.classify.engine import argmax_filter, argmax_stream

    counts = np.array([[0, 3, 1, 3, 3, 0], [0, 0, 0, 0, 0, 0], [2, 2, 2, 2, 2, 2],
                       [0, 0, 0, 0, 0, 5], [1, 0, 0, 4, 4, 1]], dtype=np.int32)
    sk_lens = np.array([5, 0, 7, 3, 9], dtype=np.int32)
    ref_lens = np.array([4, 6, 2, 8, 1, 3], dtype=np.int32)
    for tp in (1, 2, 3, 6):
        rps = 6 // tp
        c = torch.from_numpy(counts)
        for init, ref in ((-1, None), (0, torch.from_numpy(ref_lens))):
            parts = torch.stack([partial_from_counts(c[:, j * rps: (j + 1) * rps],
                                                     torch.from_numpy(sk_lens), init)
                                 for j in range(tp)])
            got = merge_tp_partials(parts, rps, 1, 2, ref).numpy()
            if ref is None:
                best, shared, diff_ok, depth, match = (np.asarray(a) for a in argmax_stream(
                    jnp.asarray(counts), 1, 2, jnp.asarray(sk_lens)))
                want = [best, shared, diff_ok | depth << 1 | match << 2]
            else:
                best, shared, tu, keep, depth, match, diff_ok = (
                    np.asarray(a) for a in argmax_filter(jnp.asarray(counts), 1, 2,
                                                         jnp.asarray(sk_lens),
                                                         jnp.asarray(ref_lens)))
                want = [best, shared, tu, keep, depth | match << 1 | diff_ok << 2]
            assert np.array_equal(got, np.stack([np.asarray(w, dtype=np.int64) for w in want]))


def test_partial_marks_no_count_above_init():
    counts = torch.tensor([[0, 0, 0], [0, 2, 2]], dtype=torch.int32)
    lens = torch.tensor([4, 5], dtype=torch.int32)
    assert partial_from_counts(counts, lens, 0).tolist() == [[INT32_MAX, 1], [0, 2], [0, 0],
                                                             [4, 5]]
    assert partial_from_counts(counts, lens, -1).tolist() == [[0, 1], [0, 2], [-1, 0], [4, 5]]


def test_partial_plain_on_the_wide_table_equals_the_logical_table(data):
    sk, lens = data["sk"], data["sk_lens"]
    logical = torch.from_numpy(build_panel_table(sk, lens).table.view(np.int32))
    wide = pack_wide_table(logical, 16)
    rows = engine.multi_k_window_hashes(torch.from_numpy(data["codes"]), KS)
    sk_rows, sk_lens = engine.bottom_s_sketch(rows, 32)
    for r, ln in ((rows, None), (sk_rows, sk_lens)):
        for init in (-1, 0):
            want = panel_probe_partial_plain(r, ln, logical, 16, init)
            assert torch.equal(panel_probe_partial_plain(r, ln, wide, 16, init), want)
            assert torch.equal(panel_probe_partial(r, ln, logical, 16, init), want)
    with pytest.raises(ValueError, match="-1 or 0"):
        panel_probe_partial(rows, None, logical, 16, 3)


def _jax_counts(table: np.ndarray, num_refs: int, rows: torch.Tensor, lens):
    """rkmh-tpu's [B, R] counts of read rows against a table, and the
    sketch lengths: raw window hashes with prefix-equality ranks (the
    short-read path, engine.py:306-311), or sorted rows."""
    from rkmh_tpu.ops import lookup as jlookup

    r = rows.numpy().view(np.uint64)
    if lens is None:
        valid = r != 0
        W = r.shape[1]
        occ = ((r[:, None, :] == r[:, :, None]) & np.tril(np.ones((W, W), bool), -1)).sum(-1)
        c = jlookup.lookup_intersection_counts_masked(
            jnp.asarray(r), jnp.asarray(valid), jnp.asarray(occ.astype(np.uint32)),
            (jnp.asarray(table),), num_refs)
        return np.array(c), valid.sum(-1).astype(np.int32)
    ln = lens.numpy()
    return np.array(jlookup.lookup_intersection_counts(jnp.asarray(r), jnp.asarray(ln),
                                                         (jnp.asarray(table),), num_refs)), ln


@pytest.mark.parametrize("rps", [30, 40], ids=["Wm1", "Wm2"])
def test_s2_shard_probes_equal_jax(rps):
    """K2's S = 2 geometry (rkmh-tpu's shard of 30 or 40 references, one or
    two mask words): on each tp = 2 shard's table, the stream and filter
    plain probes equal rkmh-tpu's counts and argmax, each shard's partial
    equals the running max of rkmh-tpu's counts, and the merged partials
    equal rkmh-tpu's argmax over the all-gathered counts; raw and sorted
    rows."""
    from rkmh_tpu.classify.engine import argmax_filter, argmax_stream

    rng = np.random.default_rng(rps)
    R = 2 * rps
    refs = [_random_dna(rng, 1500) for _ in range(R)]
    reads = []
    for i in range(96):
        r = refs[int(rng.integers(0, R))]
        at = int(rng.integers(0, len(r) - 128))
        reads.append(r[at: at + 128] if i % 2 else _random_dna(rng, 128))
    read_codes, _ = jax_encode(reads, pad_to=128)
    ref_codes, _ = jax_encode(refs, pad_to=1536)
    sk, lens = engine.sketch_batch(torch.from_numpy(ref_codes), KS, S)
    tables, got_rps = jax_mesh.build_sharded_tables(sk.numpy().view(np.uint64), lens.numpy(), 2)
    tables = np.asarray(tables)
    assert got_rps == rps and tables.shape[2] == 2 * (3 + (rps + 31) // 32)  # S = 2
    raw = engine.multi_k_window_hashes(torch.from_numpy(read_codes), KS)
    sk_rows, sk_lens = engine.bottom_s_sketch(raw, 32)
    for rows, ln in ((raw, None), (sk_rows, sk_lens)):
        counts, shard_tables = [], []
        for j in range(2):
            t = torch.from_numpy(np.ascontiguousarray(tables[j]).view(np.int32))
            c, sl = _jax_counts(tables[j], rps, rows, ln)
            shard_lens = lens[j * rps: (j + 1) * rps]
            for md, mm in ((0, -1), (1, 3)):
                best, shared, diff_ok, depth, match = (np.asarray(a) for a in argmax_stream(
                    jnp.asarray(c), md, mm, jnp.asarray(sl)))
                assert np.array_equal(panel_probe_plain(rows, ln, t, rps, md, mm).numpy(),
                                      np.stack([best, shared, diff_ok | depth << 1 | match << 2]))
                f = [np.asarray(a) for a in argmax_filter(jnp.asarray(c), md, mm, jnp.asarray(sl),
                                                          jnp.asarray(shard_lens.numpy()))]
                assert np.array_equal(
                    panel_probe_filter_plain(rows, ln, t, rps, shard_lens, md, mm).numpy(),
                    np.stack([*f[:4], f[4] | f[5] << 1 | f[6] << 2]).astype(np.int64))
            counts.append(c)
            shard_tables.append(t)
        whole = jnp.asarray(np.concatenate(counts, axis=1))
        assert int(whole.sum()) > 0
        sl = torch.from_numpy(sl)
        for init, ref in ((-1, None), (0, lens)):
            parts = torch.stack([panel_probe_partial_plain(rows, ln, t, rps, init)
                                 for t in shard_tables])
            for j in range(2):
                assert torch.equal(parts[j], partial_from_counts(torch.from_numpy(counts[j]), sl,
                                                                 init))
            got = merge_tp_partials(parts, rps, 1, 3, ref).numpy()
            if ref is None:
                best, shared, diff_ok, depth, match = (np.asarray(a) for a in argmax_stream(
                    whole, 1, 3, jnp.asarray(sl.numpy())))
                want = np.stack([best, shared, diff_ok | depth << 1 | match << 2])
            else:
                f = [np.asarray(a) for a in argmax_filter(whole, 1, 3, jnp.asarray(sl.numpy()),
                                                          jnp.asarray(lens.numpy()))]
                want = np.stack([*f[:4], f[4] | f[5] << 1 | f[6] << 2])
            assert np.array_equal(got, want.astype(np.int64))


# ---- the grid and the shard tables


def test_mesh_entries_follow_the_reference_order():
    devs = [torch.device("cpu")] * 6
    m = make_mesh(devs, dp=3, tp=2)
    assert (m.dp, m.tp) == (3, 2) and m[2, 1] == devs[5]
    assert (make_mesh(devs, tp=3).dp, make_mesh(devs, tp=3).tp) == (2, 3)
    with pytest.raises(ValueError, match=r"dp\(4\) \* tp\(2\) != devices\(6\)"):
        make_mesh(devs, dp=4, tp=2)
    assert visible_devices("cpu") == [CPU]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_tables_bit_equal_to_jax(data, tp):
    want, want_rps = jax_mesh.build_sharded_tables(data["sk"].view(np.uint64), data["sk_lens"], tp)
    got, rps = build_sharded_tables(data["sk"], data["sk_lens"], tp)
    assert rps == want_rps and got.dtype == np.uint32
    assert np.array_equal(got, np.asarray(want))
    panel = convert.sharded_tables_from_numpy(np.asarray(want), data["sk_lens"], _grid(4 // tp, tp))
    for j in range(tp):
        assert np.array_equal(panel.table(0, j).numpy().view(np.uint32), got[j])
    with pytest.raises(ValueError, match="not divisible by tp 3"):
        build_sharded_tables(data["sk"], data["sk_lens"], 3)


# ---- the steps


def _jax_counter(data, size):
    from rkmh_tpu.classify import engine as jax_engine
    from rkmh_tpu.ops.counter import HashCounter as JaxCounter

    hashes, mask = jax_engine.hash_batch_with_mask(data["codes"], data["lens"], KS)
    return JaxCounter(size).add(hashes, mask).to_numpy()


@pytest.mark.parametrize("with_counter", [False, True], ids=["plain", "M"])
@pytest.mark.parametrize("dp,tp", GEOMETRIES)
def test_sharded_steps_equal_jax(data, dp, tp, with_counter):
    size, min_occ, md, mm = 4096, 2, 1, 3
    jmesh = jax_mesh.make_mesh(jax.devices()[:4], dp=dp, tp=tp)
    tables, rps = jax_mesh.build_sharded_tables(data["sk"].view(np.uint64), data["sk_lens"], tp)
    extra, cs = (), None
    mesh = _grid(dp, tp)
    ctr = None
    if with_counter:
        table = _jax_counter(data, size)
        extra, cs = (jnp.asarray(table),), size
        ctr = convert.sharded_counter_from_numpy(table, mesh)
    step = jax_mesh.sharded_classify_table_fn(jmesh, KS, S, rps, md, mm, counter_size=cs,
                                              min_occ=min_occ)
    best, shared, diff_ok, depth, match = (np.asarray(a) for a in step(
        data["codes"], tables, *extra))
    fstep = jax_mesh.sharded_filter_table_fn(jmesh, KS, S, rps, md, mm, counter_size=cs,
                                             min_occ=min_occ)
    want_f = np.asarray(fstep(data["codes"], tables, jnp.asarray(data["sk_lens"]), *extra))

    panel = ShardedPanel.from_sketches(mesh, data["sk"], data["sk_lens"])
    got = sharded_classify_step(mesh, panel, data["codes"], KS, S, md, mm, ctr, min_occ).numpy()
    assert np.array_equal(got, np.stack([best, shared, diff_ok | depth << 1 | match << 2]))
    got_f = sharded_filter_step(mesh, panel, data["codes"], KS, S, md, mm, ctr, min_occ).numpy()
    assert np.array_equal(got_f, want_f)
    # and one device's steps on the same panel
    from rkmh_tpu_torch.commands.common import _panel_from_sketches

    sk = torch.from_numpy(data["sk"])
    one = _panel_from_sketches([str(i) for i in range(16)], sk, torch.from_numpy(data["sk_lens"]),
                               data["sk"], data["sk_lens"], CPU)
    c1 = None if ctr is None else torch.from_numpy(ctr.to_numpy())
    codes = torch.from_numpy(data["codes"])
    assert np.array_equal(got, engine.classify_codes_table(codes, one, KS, S, md, mm, c1,
                                                           min_occ).numpy())
    assert np.array_equal(got_f, engine.filter_codes_table(codes, one, KS, S, md, mm, c1,
                                                           min_occ).numpy())


def test_step_refuses_a_batch_that_does_not_split(data):
    mesh = _grid(4, 1)
    panel = ShardedPanel.from_sketches(mesh, data["sk"], data["sk_lens"])
    with pytest.raises(ValueError, match="does not split over dp 4"):
        sharded_classify_step(mesh, panel, data["codes"][:95], KS, S, 0, -1)


# ---- the counter


@pytest.mark.parametrize("dp,tp", [(4, 1), (2, 2)])
def test_sharded_counter_equals_jax_and_one_device(data, dp, tp):
    size = 40000
    jmesh = jax_mesh.make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
    add = jax_ep.sharded_counter_add_codes_fn(jmesh, size, KS)
    table = jax_ep.sharded_counter_init(jmesh, size)
    mesh = _grid(dp, tp)
    got = ShardedCounter(mesh, size)
    one = counter.HashCounter(size, CPU)
    for half in (slice(0, 48), slice(48, 96)):  # two batches
        codes, lens = data["codes"][half], data["lens"][half]
        table = add(table, codes, lens)
        got.add_codes(codes, lens, KS)
        one.add_windows(engine.multi_k_window_hashes(torch.from_numpy(codes), KS),
                        torch.from_numpy(lens), codes.shape[1], KS)
    want = np.asarray(table)
    assert np.array_equal(got.to_numpy(), want)
    assert np.array_equal(got.to_numpy(), one.to_numpy())
    back = convert.sharded_counter_from_numpy(want, mesh)
    assert np.array_equal(back.to_numpy(), want)
    # the mask over the shards equals one device's mask
    h = engine.multi_k_window_hashes(torch.from_numpy(data["codes"]), KS)
    for j in range(tp):
        assert torch.equal(got.mask(h, j, 2), counter.counter_mask(one.table, h, 2, INT32_MAX))
    with pytest.raises(ValueError, match="not divisible by 4 dp shards"):
        ShardedCounter(_grid(4, 1), 40002)


@pytest.mark.parametrize("size,parts", [(1009 * 4, 4), (4096, 2), (640000, 8)])
def test_counter_ranges_partition_the_table(size, parts):
    rng = np.random.default_rng(size)
    h = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, size=(24, 50), dtype=np.int64))
    h[rng.random(h.shape) < 0.1] = 0
    m = torch.from_numpy(rng.random(h.shape) < 0.8)
    whole = counter.counter_add_plain(torch.zeros(size, dtype=torch.int32), h, m)
    whole = counter.counter_add_plain(whole, h[:5], None)
    n = size // parts
    ranges = []
    for o in range(parts):
        c = counter.HashCounter(size, CPU, base=o * n, n_slots=n)
        c.add(h, m).add(h[:5])
        ranges.append(c)
    assert torch.equal(torch.cat([c.table for c in ranges]), whole)
    for lo, hi in ((2, INT32_MAX), (0, 1), (1, 1)):
        out = h
        for c in ranges:
            out = counter.counter_mask(c.table, out, lo, hi, c.base, c.size)
        assert torch.equal(out, counter.counter_mask(whole, h, lo, hi))
    with pytest.raises(ValueError, match="lie outside a table"):
        counter.HashCounter(size, CPU, base=n * parts - 1, n_slots=n)


# ---- sequence parallelism (parallel/sp.py)


@pytest.mark.parametrize("ks", [(16,), (12, 16)], ids=["k16", "k12-k16"])
@pytest.mark.parametrize("s", [50, 1000, 5000])
def test_sp_sketch_equals_jax_and_one_device(ks, s):
    from rkmh_tpu.parallel import sp as jax_sp
    from rkmh_tpu_torch.parallel.sp import make_sp_mesh, sp_sketch

    rng = np.random.default_rng(len(ks) + s)
    codes = rng.integers(0, 4, (3, 4096)).astype(np.uint8)
    codes[1, 100:140] = 4  # a run of N
    codes[2, -30:] = 255   # padding at the end
    want, want_lens = jax_sp.sp_sketch_fn(jax_sp.make_sp_mesh(jax.devices()[:8]), ks, s)(codes)
    got, lens = sp_sketch(make_sp_mesh(list(CPU_GRID)), codes, ks, s)
    assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))
    assert np.array_equal(lens.numpy(), np.asarray(want_lens))
    one, one_lens = engine.sketch_batch(torch.from_numpy(codes), ks, s)
    assert torch.equal(got[:, : one.shape[1]], one) and torch.equal(lens, one_lens)


def test_sp_sketch_refuses_a_row_that_does_not_split():
    from rkmh_tpu_torch.parallel.sp import make_sp_mesh, sp_sketch

    with pytest.raises(ValueError, match="do not split into 8 chunks"):
        sp_sketch(make_sp_mesh(list(CPU_GRID)), np.zeros((1, 100), np.uint8), (12,), 10)


def test_sharded_set_panel_places_each_shard_once():
    from rkmh_tpu_torch.ops.lookup import build_sharded_set_tables_device
    from rkmh_tpu_torch.parallel.mesh import ShardedSetPanel

    rng = np.random.default_rng(2)
    rows = torch.from_numpy(rng.integers(1, 2**63, (28, 50)))
    mask = torch.ones(rows.shape, dtype=torch.bool)
    mask[26:] = False  # 26 references padded to 28
    tables, rps = build_sharded_set_tables_device(rows, mask, 4)
    panel = ShardedSetPanel(_grid(2, 4), tables, rps)
    assert rps == 7 and len(panel._tables) == 4
    for j in range(4):
        assert panel.table(1, j) is panel.table(0, j)
        assert torch.equal(panel.table(0, j), tables[j])
    with pytest.raises(ValueError, match="4 shard tables for tp 2"):
        ShardedSetPanel(_grid(4, 2), tables, rps)
