"""hpv16's sorted-panel fallback (K10's function) in the port vs the JAX
package.

``build_sorted_panel`` must give the JAX package's arrays on the
synthetic panel's hash sets and on edge rows (an empty row, zeros, keys
>= 2**63, keys shared across references, R = 1, R = 33, no key at all).
``sorted_panel_counts(_masked)``, ``sorted_probe_plain`` (what K10 must
match on the card) and ``engine.hpv16_sorted_batch`` must equal their JAX
counterparts on seeded inputs, with and without a read counter, on the
JAX-built panel carried over by ``convert.sorted_panel_from_numpy``.
``hpv16`` and ``hpv16 -M 2`` past the set-table cap
(``RKMH_TPU_SET_TABLE_MAX_MB=0``) must be byte-identical to rkmh-tpu's
under the same cap and to the port's own bucket-table output.  K10's
directory over the keys' top bits must equal a numpy count of them (the
640-type panel's keys and edge panels), and the plain version that reads
it, ``sorted_probe_plain_dir``, must equal ``sorted_probe_plain`` and the
JAX core.  Also: what the K10 wrapper refuses.  Inputs: rkmh_tpu_torch.synth and numpy, from a
seed.  Tolerance: none, every output is an integer or text.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.classify import engine as jengine
from rkmh_tpu.commands import hpv16_cmd as jcmd
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu_torch import convert, synth
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands import hpv16_cmd
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops import lookup
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch
from rkmh_tpu_torch.ops.sorted_probe import (
    SortedPanel,
    _sorted_probe_cuda,
    build_directory,
    sorted_probe_plain,
    sorted_probe_plain_dir,
)

SMALL = dict(num_types=8, genome_len=1500)
HIGH = np.uint64(1 << 63)


def _edge_rows(case, rng):
    pool = rng.integers(1, 2**63, size=200, dtype=np.uint64)
    pool[::3] |= HIGH  # keys >= 2**63
    if case == "panel":  # the synthetic hpv16 panel's type genomes, hashed at k=16
        from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes

        panel = synth.make_hpv16_panel(3, **SMALL)
        codes, _ = encode_seqs([synth._ACGTN[g].tobytes() for g in panel.types])
        h = multi_k_window_hashes(torch.from_numpy(codes), [16]).numpy().view(np.uint64)
        return [row[row != 0] for row in h]  # padding windows hash to 0
    rows = [rng.choice(pool, 30) for _ in range(6)]
    if case == "empty-row":
        rows[2] = np.zeros(0, np.uint64)
    elif case == "zeros":
        rows[1][:10] = 0
        rows[4] = np.zeros(5, np.uint64)
    elif case == "shared":
        rows[3] = rows[0].copy()
        rows[5] = np.concatenate([rows[0][:10], rows[1][:10]])
    elif case == "R1":
        rows = rows[:1]
    elif case == "R33":
        rows = [rng.choice(pool, 12) for _ in range(33)]
    elif case == "no-key":
        rows = [np.zeros(3, np.uint64), np.zeros(0, np.uint64)]
    return rows


@pytest.mark.parametrize("case", ["panel", "empty-row", "zeros", "high-keys", "shared", "R1",
                                  "R33", "no-key"])
def test_build_sorted_panel_equals_jax(case):
    rows = _edge_rows(case, np.random.default_rng(len(case)))
    want_k, want_m = jlookup.build_sorted_panel(rows, num_refs=len(rows))
    got_k, got_m = lookup.build_sorted_panel([r.view(np.int64) for r in rows],
                                             num_refs=len(rows))
    assert got_k.dtype == want_k.dtype and got_m.dtype == want_m.dtype
    assert np.array_equal(got_k, want_k) and np.array_equal(got_m, want_m)
    if case == "high-keys":
        assert (got_k >= HIGH).any() and (got_k < HIGH).any()
    every = np.concatenate(rows) if rows else np.zeros(0, np.uint64)
    assert lookup.count_unique_keys_device(
        torch.from_numpy(every[None].view(np.int64)), torch.ones((1, every.size), dtype=torch.bool)
    ) == int(jlookup._count_unique_keys(jnp.asarray(every[None]), jnp.ones((1, every.size), bool)))


def _panel_and_rows(seed, R=40, n_rows=24, width=48):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**64 - 1, size=300, dtype=np.uint64)
    pool[::4] |= HIGH
    keys, masks = jlookup.build_sorted_panel([rng.choice(pool, 40) for _ in range(R)], R)
    sk = np.sort(rng.choice(np.concatenate([pool, rng.integers(1, 2**63, 60, dtype=np.uint64)]),
                            size=(n_rows, width)), axis=1)
    sk[3] = sk[3, 0]  # a row of one repeated value
    lens = rng.integers(0, width + 1, n_rows).astype(np.int32)
    lens[3] = width
    sk[np.arange(width)[None, :] >= lens[:, None]] = np.uint64(2**64 - 1)
    return keys, masks, sk, lens


def test_sorted_panel_counts_match_jax():
    keys, masks, sk, lens = _panel_and_rows(1)
    panel = convert.sorted_panel_from_numpy(keys, masks, "cpu")
    rows, ln = torch.from_numpy(sk.view(np.int64)), torch.from_numpy(lens)
    want = np.asarray(jlookup.sorted_panel_counts(jnp.asarray(sk), jnp.asarray(lens),
                                                  jnp.asarray(keys), jnp.asarray(masks), 40))
    got = lookup.sorted_panel_counts(rows, ln, panel.keys, panel.masks, 40)
    assert np.array_equal(got.numpy(), want) and want.max() > 0
    qmask = np.random.default_rng(2).random(sk.shape) < 0.7  # any query mask, duplicates too
    want = np.asarray(jlookup.sorted_panel_counts_masked(
        jnp.asarray(sk), jnp.asarray(qmask), jnp.asarray(keys), jnp.asarray(masks), 40))
    got = lookup.sorted_panel_counts_masked(rows, torch.from_numpy(qmask), panel.keys,
                                            panel.masks, 40)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("T,U", [(30, 10), (1, 0), (40, 0)])
def test_sorted_probe_plain_matches_the_jax_core(T, U):
    keys, masks, sk, lens = _panel_and_rows(3)
    panel = convert.sorted_panel_from_numpy(keys, masks, "cpu")
    counts = jlookup.sorted_panel_counts(jnp.asarray(sk), jnp.asarray(lens), jnp.asarray(keys),
                                         jnp.asarray(masks), T + U)
    want = np.concatenate([np.asarray(jnp.argmax(counts[:, :T], -1))[:, None],
                           np.asarray(jnp.max(counts[:, :T], -1))[:, None],
                           np.asarray(counts[:, T:])], axis=1)
    got = sorted_probe_plain(torch.from_numpy(sk.view(np.int64)), torch.from_numpy(lens), panel,
                             T, U)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_counter", [False, True])
def test_hpv16_sorted_batch_matches_jax(with_counter):
    ks, T = (16, 18), 8
    panel = synth.make_hpv16_panel(3, **SMALL)
    codes_t, _ = encode_seqs([synth._ACGTN[g].tobytes() for g in panel.types + panel.subs])
    h = engine.multi_k_window_hashes(torch.from_numpy(codes_t), [16]).numpy().view(np.uint64)
    keys, masks = jlookup.build_sorted_panel([r[r != 0] for r in h], len(h))
    reads, _ = synth.make_nanopore_reads(12, 9, panel, mean_len=900, min_len=200, max_len=2000,
                                         n_rate=0.01)
    codes, lens = encode_seqs([r.tobytes() for r in reads] + [b"", b"ACGT"])
    U = len(h) - T
    counter = None
    if with_counter:  # a small lossy counter table: collisions on purpose
        counter = np.random.default_rng(5).integers(0, 4, 1009).astype(np.int32)
    mine = convert.sorted_panel_from_numpy(keys, masks, "cpu")
    for Wc in (engine.hpv16_compact_width(lens, codes.shape[1], ks),
               sum(codes.shape[1] - k + 1 for k in ks)):
        want = np.asarray(jengine.hpv16_sorted_batch(
            codes, jnp.asarray(keys), jnp.asarray(masks), ks, T, U, Wc,
            None if counter is None else jnp.asarray(counter), 2))
        got = engine.hpv16_sorted_batch(torch.from_numpy(codes), mine, ks, T, U, Wc,
                                        None if counter is None else torch.from_numpy(counter), 2)
        assert np.array_equal(got.numpy(), want)
    assert want[:, 1].max() > 0 and (want[-2:] == 0).all()


@pytest.fixture(scope="module")
def refpath(tmp_path_factory):
    d = tmp_path_factory.mktemp("sorted_panel")
    full = synth.write_hpv16_refpath(str(d / "full"), seed=3, **SMALL)
    reads, _ = synth.make_nanopore_reads(24, 5, full, mean_len=900, min_len=900, max_len=900,
                                         n_rate=0.01)
    synth.write_fastq_records(str(d / "r.fq"), reads)
    return str(d / "full"), str(d / "r.fq")


@pytest.mark.parametrize("M", [0, 2])
def test_hpv16_past_the_cap_byte_identical_to_jax(refpath, tmp_path, monkeypatch, capsys, M):
    ref, reads = refpath
    kw = dict(read_files=[reads], refpath=ref, ks=(16,), batch_size=8, min_kmer_occ=M,
              counter_size=4099)
    out = {}
    for cap in ("0", None):
        if cap is None:
            monkeypatch.delenv("RKMH_TPU_SET_TABLE_MAX_MB", raising=False)
        else:
            monkeypatch.setenv("RKMH_TPU_SET_TABLE_MAX_MB", cap)
        runs = (("jax", jcmd, {}), ("torch", hpv16_cmd, {"device": "cpu"}))
        for name, mod, extra in runs[:2 if cap else 1][::-1] if cap else runs[1:]:
            wd = tmp_path / f"{name}{cap}"
            wd.mkdir()
            monkeypatch.chdir(wd)
            buf = io.StringIO()
            assert mod.run(mod.Hpv16Config(**kw, **extra), out=buf) == 0
            out[name, cap] = buf.getvalue(), (wd / "lineage_specific_hashes.16.tst").read_text()
            err = capsys.readouterr().err
            assert ("using the sorted-key panel" in err) == (cap == "0"), (name, cap)
    assert len(out["jax", "0"][0].splitlines()) == 24
    assert out["torch", "0"] == out["jax", "0"]
    assert out["torch", None] == out["torch", "0"]  # the bucket-table path, same bytes


def _directory_keys(case):
    rng = np.random.default_rng(len(case))
    if case == "640-types":  # the fallback panel's type genomes, hashed at k = 18
        from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes

        panel = synth.make_hpv16_panel(0, num_types=640)
        codes, _ = encode_seqs([synth._ACGTN[g].tobytes() for g in panel.types])
        h = multi_k_window_hashes(torch.from_numpy(codes), [18]).numpy().view(np.uint64)
        return np.unique(h[h != 0])
    if case == "U1":
        return np.array([2**63 + 77], dtype=np.uint64)
    if case == "one-bucket":  # every key shares its top 20 bits
        return np.unique((np.uint64(0x8F00F) << np.uint64(44))
                         | rng.integers(0, 2**44, 5000, dtype=np.uint64))
    if case == "high-keys-only":
        return np.unique(rng.integers(0, 2**63, 3000, dtype=np.uint64) | HIGH)
    # empty buckets at both ends: keys in the middle quarters only
    return np.unique(rng.integers(2**62, 3 * 2**62, 3000, dtype=np.uint64))


@pytest.mark.parametrize("case", ["640-types", "U1", "one-bucket", "high-keys-only",
                                  "empty-ends"])
def test_directory_equals_a_numpy_count(case):
    keys = _directory_keys(case)
    d, bits = build_directory(keys)
    assert bits == max(8, keys.size.bit_length() - 2) and d.dtype == np.int32
    top = keys >> np.uint64(64 - bits)
    buckets, counts = np.unique(top, return_counts=True)
    want = np.zeros(1 << bits, np.int64)
    want[buckets.astype(np.int64)] = counts
    assert np.array_equal(np.diff(d), want) and d[0] == 0 and d[-1] == keys.size
    starts = (np.arange(1 << bits, dtype=np.uint64) << np.uint64(64 - bits))
    assert np.array_equal(d[:-1], np.searchsorted(keys, starts))
    if case == "640-types":
        assert bits == 21 and keys.size > 5_000_000 and want.mean() < 4
    elif case == "one-bucket":
        assert (want > 0).sum() == 1
    elif case == "high-keys-only":
        assert (want[: 1 << (bits - 1)] == 0).all() and want[-1] > 0
    elif case == "empty-ends":
        assert want[0] == 0 and want[-1] == 0
    panel = convert.sorted_panel_from_numpy(keys, np.zeros((keys.size, 1), np.uint32), "cpu",
                                            (d, bits))
    assert panel.bits == bits and np.array_equal(panel.dir.numpy(), d)
    assert np.array_equal(panel.keys.numpy() ^ np.int64(-(2**63)), keys.view(np.int64))
    assert panel.directory_bytes == 4 * d.size
    assert panel.nbytes == 8 * keys.size + 4 * keys.size + 4 * d.size


@pytest.mark.parametrize("case", ["-M-zeroed", "one-value", "long-read"])
def test_directory_plain_equals_the_logical_plain_and_jax(case):
    """The directory's plain version against ``sorted_probe_plain`` and the
    JAX core ``_hpv16_sorted_core`` on seeded window-hash rows."""
    rng = np.random.default_rng(len(case) + 40)
    pool = rng.integers(1, 2**64 - 1, size=3000, dtype=np.uint64)
    pool[::4] |= HIGH
    T, U = 30, 10
    keys, masks = jlookup.build_sorted_panel([rng.choice(pool, 400) for _ in range(T + U)],
                                             T + U)
    W = 2600 if case == "long-read" else 300  # past one 2,048-element segment
    hashes = rng.choice(np.concatenate([pool, rng.integers(1, 2**63, 500, dtype=np.uint64)]),
                        size=(12, W))
    if case == "-M-zeroed":
        hashes[rng.random(hashes.shape) < 0.4] = 0
        hashes[3] = 0  # every hash of a read zeroed
    elif case == "one-value":
        hashes[::2] = hashes[::2, :1]
    want = np.asarray(jengine._hpv16_sorted_core(jnp.asarray(hashes), jnp.asarray(keys),
                                                 jnp.asarray(masks), W, T, U, None, 0))
    full, lens = bottom_s_sketch(torch.from_numpy(hashes.view(np.int64)), W)
    panel = convert.sorted_panel_from_numpy(keys, masks, "cpu")
    got = sorted_probe_plain_dir(full, lens, panel, T, U)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, sorted_probe_plain(full, lens, panel, T, U))
    assert want[:, 1].max() > 0


def test_sorted_probe_wrapper_rejects_what_it_cannot_take():
    keys, masks, sk, lens = _panel_and_rows(4)
    panel = convert.sorted_panel_from_numpy(keys, masks, "cpu")
    rows, ln = torch.from_numpy(sk.view(np.int64)), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="int64 rows"):
        _sorted_probe_cuda(rows.to(torch.int32), ln, panel, 30, 10)
    with pytest.raises(ValueError, match="SortedPanel"):
        _sorted_probe_cuda(rows, ln, (panel.keys, panel.masks), 30, 10)
    with pytest.raises(ValueError, match="int64 keys"):
        _sorted_probe_cuda(rows, ln, SortedPanel(panel.keys[:0], panel.masks[:0]), 30, 10)
    with pytest.raises(ValueError, match="masks"):
        _sorted_probe_cuda(rows, ln, SortedPanel(panel.keys, panel.masks[1:]), 30, 10)
    with pytest.raises(ValueError, match="mask words"):
        _sorted_probe_cuda(rows, ln, panel, 30, 40)
    with pytest.raises(ValueError, match="type"):
        _sorted_probe_cuda(rows, ln, panel, 0, 10)
    with pytest.raises(ValueError, match="lens"):
        _sorted_probe_cuda(rows, ln[:-1], panel, 30, 10)
    with pytest.raises(ValueError, match="distinct and ascending"):
        convert.sorted_panel_from_numpy(keys[::-1], masks, "cpu")
    with pytest.raises(ValueError, match="no directory"):  # the layout K10 needs
        _sorted_probe_cuda(rows, ln, SortedPanel(panel.keys, panel.masks), 30, 10)
    with pytest.raises(ValueError, match="directory is int32"):
        _sorted_probe_cuda(rows, ln, SortedPanel(panel.keys, panel.masks, panel.dir[:-1],
                                                 panel.bits), 30, 10)
    with pytest.raises(ValueError, match="16-byte boundary"):
        _sorted_probe_cuda(rows, ln, SortedPanel(panel.keys[1:], panel.masks[1:], panel.dir,
                                                 panel.bits), 30, 10)
    with pytest.raises(ValueError, match="no directory"):
        sorted_probe_plain_dir(rows, ln, SortedPanel(panel.keys, panel.masks), 30, 10)
