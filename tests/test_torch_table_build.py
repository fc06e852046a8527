"""The port's device table builds (``ops/lookup.py`` section (d)) against
rkmh-tpu's (``rkmh_tpu/ops/lookup.py:430-611``).

The port runs on the CPU, where the fill is ``set_table_fill_plain`` (K13,
``csrc/set_table.cu``, is held to it on the card: tests/test_torch_kernels.py
and chip_smoke.py phase 40); rkmh-tpu runs its jitted builds on the CPU.
Inputs are made from a seed with numpy.  Tolerance: none, the tables' bits,
``max_rank`` and every count must be equal.

* ``build_set_table_device``, ``count_unique_keys_device`` and
  ``build_panel_table_device`` (sorted sketch rows: occ > 0, repeated
  values) on rows with zeros, masked elements, duplicates, keys shared
  between rows and hashes on both sides of 2**63, at R = 1, 31, 33 and 70
  (Wm 1-3);
* ``device_set_table`` at a forced small bucket count: an overflow (and the
  table it gives), and a (lo, occ) collision in one bucket found by search;
* ``set_table_fill_plain`` against rkmh-tpu's chain (:489-516, run below as
  JAX ops on the same sorted entries), with left-out entries, ranks past S
  and collisions, and at the geometries of K13's tiles
  (``bench/fill_cases``: S 2-12 by Wm 1-64 at a bucket count no tile
  divides, no entries, rows wider than a tile);
* the device table and the numpy ``build_set_table``: equal counts on the
  same queries (their slots lie in another order in a bucket);
* ``hpv16_cmd.build_tables``'s combined table against rkmh-tpu's;
* ``stream`` with the device build forced on a small panel
  (``common.DEVICE_BUILD_MIN_ELEMENTS``): rkmh-tpu's bytes.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.commands import hpv16_cmd as jhpv16
from rkmh_tpu.commands import stream as jstream
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.bench import fill_cases
from rkmh_tpu_torch.commands import common, hpv16_cmd, stream
from rkmh_tpu_torch.ops import lookup

HIGH = np.uint64(1 << 63)
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
RS = (1, 31, 33, 70)
W = 48


def _rows(R, seed=0):
    """[R, W] uint64 hashes and a mask: zeros, masked elements, repeats in a
    row, keys shared between rows, hashes >= 2**63."""
    rng = np.random.default_rng(seed + R)
    pool = rng.integers(1, 2**63, size=3 * W, dtype=np.uint64)
    pool[::3] |= HIGH
    h = rng.choice(pool, size=(R, W))
    h[:, ::11] = 0
    h[:, 1] = h[:, 2]  # a repeat in every row
    m = rng.random((R, W)) < 0.85
    return h, m


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64) if a.dtype == np.uint64
                            else np.ascontiguousarray(a))


def _bits(table) -> np.ndarray:
    return np.asarray(table).view(np.int32)


@pytest.mark.parametrize("R", RS)
def test_set_table_and_count_equal_jax(R):
    h, m = _rows(R)
    want = jlookup.build_set_table_device(jnp.asarray(h), jnp.asarray(m), R)
    got = lookup.build_set_table_device(_t(h), _t(m), R)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), _bits(want))
    assert lookup.count_unique_keys_device(_t(h), _t(m)) == int(
        jlookup._count_unique_keys(jnp.asarray(h), jnp.asarray(m)))
    # with a given entry estimate, as hpv16 passes its count
    n = lookup.count_unique_keys_device(_t(h), _t(m))
    assert torch.equal(lookup.build_set_table_device(_t(h), _t(m), R, est_entries=n), got)


def _sketch_rows(R, seed=0):
    """Sorted sketch rows [R, W] (SENTINEL-padded, runs of equal values)
    and their lengths."""
    h, m = _rows(R, seed)
    rng = np.random.default_rng(seed)
    sk = np.full((R, W), SENT, dtype=np.uint64)
    lens = np.zeros(R, np.int32)
    for i in range(R):
        row = h[i][m[i] & (h[i] != 0)]
        row = np.sort(np.concatenate([row, row[: int(rng.integers(0, 6))]]))[:W]
        sk[i, : len(row)], lens[i] = row, len(row)
    return sk, lens


@pytest.mark.parametrize("R", RS)
def test_panel_table_equals_jax(R):
    sk, lens = _sketch_rows(R)
    want = jlookup.build_panel_table_device(jnp.asarray(sk), jnp.asarray(lens))
    got = lookup.build_panel_table_device(_t(sk), _t(lens))
    assert np.array_equal(got.numpy(), _bits(want))
    occ = got.view(got.shape[0], -1, lookup.table_slots(got.shape[1], R))[:, 2]
    assert int(occ.max()) > 0  # entries of occ > 0 are there
    qmask = np.arange(W)[None, :] < lens[:, None]
    assert lookup.count_unique_keys_device(_t(sk), _t(qmask), lookup.occ_ranks(_t(sk))) == int(
        jlookup._count_unique_keys(jnp.asarray(sk), jnp.asarray(qmask),
                                   jlookup_occ_ranks(jnp.asarray(sk))))


def jlookup_occ_ranks(sk):
    from rkmh_tpu.ops.intersect import occ_ranks

    return occ_ranks(sk)


def test_overflow_at_a_forced_bucket_count_equals_jax():
    h, m = _rows(33)
    want, want_rank = jlookup._device_set_table(jnp.asarray(h), jnp.asarray(m), 8, 33, slots=2)
    got, rank = lookup.device_set_table(_t(h), _t(m), 8, 33, slots=2)
    assert int(rank) == int(want_rank) > 2
    assert np.array_equal(got.numpy(), _bits(want))


def _colliding_pair(nb: int, seed: int = 5):
    """Two hashes of one lo and different hi in one bucket at nb buckets."""
    rng = np.random.default_rng(seed)
    lo = int(rng.integers(1, 2**32))
    hi = np.arange(1, 4 * nb + 1, dtype=np.int64) * 7919
    b = lookup.bucket_indices(torch.full((hi.size,), lo), torch.from_numpy(hi),
                              torch.zeros(hi.size, dtype=torch.int64), nb).numpy()
    j = 1 + int(np.nonzero(b[1:] == b[0])[0][0])
    return np.array([hi[0] << 32 | lo, hi[j] << 32 | lo], dtype=np.uint64)


def test_collision_at_a_forced_bucket_count_equals_jax():
    nb, slots = 32, 8
    pair = _colliding_pair(nb)
    h, m = _rows(3)
    h[0, 0], h[2, 5], m[0, 0], m[2, 5] = pair[0], pair[1], True, True
    want, want_rank = jlookup._device_set_table(jnp.asarray(h), jnp.asarray(m), nb, 3,
                                                slots=slots)
    got, rank = lookup.device_set_table(_t(h), _t(m), nb, 3, slots=slots)
    assert int(rank) == int(want_rank) == slots
    assert np.array_equal(got.numpy(), _bits(want))
    # grown until the pair parts: the same table as rkmh-tpu's build
    assert np.array_equal(lookup.build_set_table_device(_t(h), _t(m), 3).numpy(), _bits(
        jlookup.build_set_table_device(jnp.asarray(h), jnp.asarray(m), 3)))


def _jax_chain(sb, sl, soc, shi, sm_i, maskbuf, nb, slots):
    """rkmh_tpu/ops/lookup.py:489-516 on sorted entries, as JAX ops."""
    N, Wm = sb.shape[0], maskbuf.shape[1]
    iota = jnp.arange(N, dtype=jnp.int32)
    run_first = jnp.concatenate([jnp.ones(1, bool), sb[1:] != sb[:-1]])
    run_start = jax.lax.associative_scan(jnp.maximum, jnp.where(run_first, iota, 0))
    rank = iota - run_start
    smask = maskbuf[sm_i]
    svalid = sb < nb
    collide = ~run_first[1:] & (sl[1:] == sl[:-1]) & (soc[1:] == soc[:-1]) & svalid[1:]
    max_rank = jnp.maximum(jnp.max(jnp.where(svalid, rank, -1)),
                           jnp.where(jnp.any(collide), slots, -1))
    table = jnp.zeros((nb + 1, slots * (3 + Wm)), jnp.uint32)
    table = table.at[:, 2 * slots: 3 * slots].set(np.uint32(0xFFFFFFFF))
    b_safe = jnp.where(svalid & (rank < slots), sb, nb)
    r_safe = jnp.clip(rank, 0, slots - 1)
    table = table.at[b_safe, r_safe].set(shi)
    table = table.at[b_safe, slots + r_safe].set(sl)
    table = table.at[b_safe, 2 * slots + r_safe].set(soc)
    for w in range(Wm):
        table = table.at[b_safe, (3 + w) * slots + r_safe].set(smask[:, w])
    return table[:nb], max_rank


# K13's tile geometries (``bench/fill_cases``): each S x Wm at 1,029 buckets
# (no tile divides it), with a crowded bucket, a collision and left-out
# entries; no entries at the widest of them; rows cut into two windows
FILL_GEOMETRIES = {f"S{S}-Wm{Wm}": dict(S=S, Wm=Wm) for S, Wm in fill_cases.GEOMETRIES}
FILL_GEOMETRIES["empty-S12-Wm64"] = dict(S=12, Wm=64, n=0)
FILL_GEOMETRIES["windows-S12-Wm700"] = dict(S=fill_cases.WIDE[0], Wm=fill_cases.WIDE[1], nb=7)


@pytest.mark.parametrize("case", ["fits", "overflow", "collision", "left-out", "empty",
                                  *FILL_GEOMETRIES])
def test_fill_plain_equals_the_jax_chain(case):
    if case in FILL_GEOMETRIES:
        g = dict(FILL_GEOMETRIES[case])
        S, nb = g.pop("S"), g.pop("nb", fill_cases.NB)
        inputs = fill_cases.fill_case(S, nb=nb, seed=11, **g)
        n = inputs[0].size
        got, rank = lookup.set_table_fill_plain(*map(torch.from_numpy, inputs), nb, S)
        if n:
            want, want_rank = _jax_chain(*(jnp.asarray(a.view(np.uint32)) for a in inputs), nb, S)
        else:
            want, want_rank = np.zeros(tuple(got.shape), np.uint32), -1
            want[:, 2 * S: 3 * S] = 0xFFFFFFFF
        assert int(rank) == int(want_rank) and np.array_equal(got.numpy(), _bits(want))
        if n:
            assert int(rank) >= S and int((inputs[0] == nb).sum()) == 5
        return
    rng = np.random.default_rng(len(case))
    nb, slots, Wm, n = 16, 3, 2, 40
    if case == "empty":
        n = 0
    b = np.sort(rng.integers(0, nb, n)).astype(np.int32)
    if case == "fits":
        b = np.sort(rng.choice(np.repeat(np.arange(nb), slots), n, replace=False)).astype(np.int32)
    if case == "left-out":
        b[-7:] = nb
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    occ = rng.integers(0, 3, n).astype(np.uint32)
    if case == "collision":
        b[:2], lo[1], occ[1] = b[0], lo[0], occ[0]
        b = np.sort(b)
    order = np.lexsort((occ, lo, b))
    b, lo, occ = b[order], lo[order], occ[order]
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    idx = rng.permutation(n).astype(np.int32)
    masks = rng.integers(0, 2**32, (max(n, 1), Wm), dtype=np.uint64).astype(np.uint32)
    want, want_rank = _jax_chain(*map(jnp.asarray, (b, lo, occ, hi, idx, masks)), nb, slots) \
        if n else (np.full((nb, slots * (3 + Wm)), 0, np.uint32), -1)
    if not n:
        want[:, 2 * slots: 3 * slots] = 0xFFFFFFFF
    got, rank = lookup.set_table_fill_plain(
        *(torch.from_numpy(a.view(np.int32)) for a in (b, lo, occ, hi, idx, masks)), nb, slots)
    assert rank.dtype == torch.int32 and rank.shape == (1,) and int(rank) == int(want_rank)
    assert np.array_equal(got.numpy(), _bits(want))
    if case in ("overflow", "collision"):
        assert int(rank) >= slots
    if case == "fits":
        assert int(rank) < slots


@pytest.mark.parametrize("R", (31, 70))
def test_device_and_host_set_tables_count_alike(R):
    h, m = _rows(R, seed=9)
    device = lookup.build_set_table_device(_t(h), _t(m), R)
    host = lookup.build_set_table([h[i][m[i]] for i in range(R)], num_refs=R).table
    assert device.shape == host.shape
    rng = np.random.default_rng(R)
    q = np.sort(rng.choice(np.concatenate([h.reshape(-1), rng.integers(1, 2**63, 200).astype(
        np.uint64)]), size=(16, 64)), axis=1)
    lens = torch.from_numpy(rng.integers(0, 65, 16).astype(np.int32))
    got = lookup.lookup_intersection_counts(_t(q), lens, device, R)
    assert torch.equal(got, lookup.lookup_intersection_counts(
        _t(q), lens, torch.from_numpy(host.view(np.int32)), R))
    assert int(got.sum()) > 0


@pytest.fixture(scope="module")
def hpv16_refpath(tmp_path_factory):
    d = tmp_path_factory.mktemp("table_build")
    synth.write_hpv16_refpath(str(d), seed=3, num_types=12, genome_len=2000)
    return str(d)


def test_hpv16_comb_table_equals_jax(hpv16_refpath, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    want = jhpv16.build_tables(jhpv16.Hpv16Config(refpath=hpv16_refpath, tst_file=False), (16,))
    tb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(refpath=hpv16_refpath, tst_file=False),
                                (16,), torch.device("cpu"))
    assert tb.comb_table is tb.probe_table  # the CPU probes the logical table
    assert np.array_equal(tb.comb_table.numpy(), _bits(want.comb_table))
    assert {"count", "device_build"} <= set(tb.setup_s) and "h2d" not in tb.setup_s


@pytest.fixture(scope="module")
def zika_small(tmp_path_factory):
    d = tmp_path_factory.mktemp("table_build_stream")
    refs, reads, _, _ = synth.write_workload(str(d), 200, 150, num_refs=40, genome_len=1500,
                                             seed=21)
    return refs, reads


def test_stream_on_a_device_built_panel_equals_jax(zika_small, monkeypatch):
    refs, reads = zika_small
    built = []
    real = common.build_panel_table_device

    def spy(sk, lens, *a):
        built.append(sk.shape)
        return real(sk, lens, *a)

    monkeypatch.setattr(common, "DEVICE_BUILD_MIN_ELEMENTS", 1)
    monkeypatch.setattr(common, "build_panel_table_device", spy)
    kw = dict(ref_files=[refs], read_files=[reads], ks=(12,), batch_size=64)
    want, got = io.StringIO(), io.StringIO()
    assert jstream.run(jstream.StreamConfig(**kw), out=want) == 0
    assert stream.run(stream.StreamConfig(**kw, device="cpu"), out=got) == 0
    assert built == [(40, 1000)]
    assert got.getvalue() == want.getvalue() and len(want.getvalue().splitlines()) == 200
