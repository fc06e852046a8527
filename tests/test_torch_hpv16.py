"""`rkmh-tpu-torch hpv16` and its parts vs the JAX package.

Both packages run on the same synthetic refpaths (rkmh_tpu_torch.synth,
cut down to 12 types x ~2 kb plus HPV16 sublineages) and the same
nanopore-like reads (300-3,000 bp, made from a seed); the port runs its
plain path on the CPU.  Cases: -k 16, -k 16 -k 18 (tables at ks[0],
reads at both), a refpath with one lineage letter (the single-group
family skips the subtraction), a batch that holds one long read among
short ones (the probe width comes from the unpadded lengths), and -M on
reads with N bases (small counters that force collisions, a power of two
and a decimal prime).  Hashes >= 2**63 appear throughout.  Tolerance: none; every output is integer or
text and must be equal byte for byte.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.classify import engine as jengine
from rkmh_tpu.commands import hpv16_cmd as jcmd
from rkmh_tpu.ops import intersect as jintersect
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu.ops.hashing import window_mask as jax_window_mask
from rkmh_tpu_torch import cli, convert, synth
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands import hpv16_cmd
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops import lookup
from rkmh_tpu_torch.ops.hashing import window_mask
from rkmh_tpu_torch.ops.set_probe import _set_probe_cuda, pack_set_table, set_probe

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
SMALL = dict(num_types=12, genome_len=2000)


def _reads(path, seqs):
    synth.write_fastq_records(str(path), seqs)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("hpv16")
    full = synth.write_hpv16_refpath(str(d / "full"), seed=3, **SMALL)
    one = synth.write_hpv16_refpath(str(d / "one"), seed=4, sublineages=("A1", "A2", "A3", "A4"),
                                    **SMALL)
    kw = dict(mean_len=1200, min_len=300, max_len=3000)
    mixed, _ = synth.make_nanopore_reads(40, 5, full, **kw)
    mixed_one, _ = synth.make_nanopore_reads(40, 6, one, **kw)
    # one 3,000 bp read among 39 of 300-1,200 bp: with 8-read batches it
    # shares its length bucket and its batch with five 1,200 bp reads
    skew, _ = synth.make_nanopore_reads(40, 7, full, mean_len=1100, min_len=300, max_len=1200)
    skew[17] = synth.make_nanopore_reads(1, 8, full, mean_len=3000, min_len=3000,
                                         max_len=3000)[0][0]
    with_n, _ = synth.make_nanopore_reads(40, 9, full, n_rate=0.01, **kw)
    return {"full": str(d / "full"), "one": str(d / "one"),
            "mixed": _reads(d / "mixed.fq", mixed), "mixed_one": _reads(d / "mixed1.fq", mixed_one),
            "skew": _reads(d / "skew.fq", skew), "with_n": _reads(d / "with_n.fq", with_n)}


def _run_both(tmp_path, monkeypatch, refpath, reads, ks, batch_size=8, **kw):
    out, tst = {}, {}
    for name, mod, extra in (("jax", jcmd, {}), ("torch", hpv16_cmd, {"device": "cpu"})):
        wd = tmp_path / name
        wd.mkdir()
        monkeypatch.chdir(wd)  # the .tst side file lands in the working directory
        buf = io.StringIO()
        assert mod.run(mod.Hpv16Config(read_files=[reads], refpath=refpath, ks=ks,
                                       batch_size=batch_size, **kw, **extra), out=buf) == 0
        out[name] = buf.getvalue()
        tst[name] = (wd / f"lineage_specific_hashes.{ks[0]}.tst").read_text()
    return out, tst


@pytest.mark.parametrize("refpath,reads,ks", [
    ("full", "mixed", (16,)),
    ("full", "mixed", (16, 18)),
    ("one", "mixed_one", (16,)),
    ("full", "skew", (16,)),
], ids=["k16", "k16-k18", "one-lineage", "long-among-short"])
def test_hpv16_output_byte_identical_to_jax(data, tmp_path, monkeypatch, refpath, reads, ks):
    out, tst = _run_both(tmp_path, monkeypatch, data[refpath], data[reads], ks)
    lines = out["jax"].splitlines()
    assert len(lines) == 40 and all(len(ln.split("\t")) == 7 for ln in lines)
    assert out["torch"] == out["jax"]
    assert tst["torch"] == tst["jax"]
    assert any(int(ln.split("\t")[2].split("/")[0]) > 0 for ln in lines)  # reads do match


@pytest.mark.parametrize("ks,kw", [
    ((16,), dict(min_kmer_occ=2, counter_size=65536)),
    ((16, 18), dict(min_kmer_occ=3, counter_size=100_003)),
], ids=["M2-pow2", "M3-prime-k16-k18"])
def test_hpv16_M_byte_identical_to_jax(data, tmp_path, monkeypatch, ks, kw):
    out, tst = _run_both(tmp_path, monkeypatch, data["full"], data["with_n"], ks, **kw)
    assert len(out["jax"].splitlines()) == 40
    assert out["torch"] == out["jax"]
    assert tst["torch"] == tst["jax"]
    plain = io.StringIO()  # the counter changed what the reads share
    hpv16_cmd.run(hpv16_cmd.Hpv16Config(read_files=[data["with_n"]], refpath=data["full"],
                                        ks=ks, batch_size=8, tst_file=False, device="cpu"),
                  out=plain)
    assert plain.getvalue() != out["torch"]


def test_cli_hpv16_matches_jax(data, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "out.tsv")
    assert cli.main(["hpv16", "-f", data["mixed"], "-R", data["full"], "-k", "16",
                     "-N", "3", "--batch-size", "16", "--device", "cpu", "-o", out]) == 0
    err = capsys.readouterr().err
    assert "-N/-D are parsed but dead" in err and "Lineage specific kmer table" in err
    want = io.StringIO()
    jcmd.run(jcmd.Hpv16Config(read_files=[data["mixed"]], refpath=data["full"], ks=(16,),
                              tst_file=False), out=want)
    with open(out) as fh:
        assert fh.read() == want.getvalue()


@pytest.mark.parametrize("flag", [["--dist-coordinator", "h:1"], ["--devices", "2"],
                                  ["--resume"], ["--tp", "2"], ["--dist-procs", "2"],
                                  ["--metrics"]])
def test_cli_rejects_flags_not_yet_ported(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["hpv16", "-f", "reads.fq", "-R", "refs", *flag])
    assert exc.value.code == 2
    assert f"{flag[0]} not yet ported" in capsys.readouterr().err


def test_run_rejects_config_not_yet_ported():
    with pytest.raises(ValueError, match="--resume, --tp not yet ported"):
        hpv16_cmd.run(hpv16_cmd.Hpv16Config(min_kmer_occ=2, resume=True, tp=2, device="cpu"))


def test_table_past_the_cap_names_the_missing_fallback(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(hpv16_cmd, "SET_TABLE_MAX_MB", 0)
    with pytest.raises(RuntimeError, match="sorted-panel fallback"):
        hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(refpath=data["full"]), (16,),
                               torch.device("cpu"))


def test_hpv16_batch_comb_on_a_jax_built_table(data, tmp_path, monkeypatch):
    """The port's plain step on the JAX package's device-built combined
    table, carried over by convert.set_table_from_numpy, equals JAX's step."""
    monkeypatch.chdir(tmp_path)
    ks = (16, 18)
    tb = jcmd.build_tables(jcmd.Hpv16Config(refpath=data["full"], tst_file=False), ks)
    T, U = len(tb.type_names), tb.n_lin + tb.n_sub
    table = convert.set_table_from_numpy(np.asarray(tb.comb_table), "cpu")
    assert table.dtype == torch.int32 and (table.numpy().view(np.uint32) >= 2**31).any()
    reads, _ = synth.make_nanopore_reads(12, 9, synth.make_hpv16_panel(3, **SMALL),
                                         mean_len=1200, min_len=300, max_len=3000)
    codes, lens = encode_seqs([r.tobytes() for r in reads] + [b"", b"ACGT", b"N" * 40])
    for Wc in (engine.hpv16_compact_width(lens, codes.shape[1], ks),
               sum(codes.shape[1] - k + 1 for k in ks)):
        want = np.asarray(jengine.hpv16_batch_comb(codes, tb.comb_table, ks, T, U, Wc))
        got = engine.hpv16_batch_comb(torch.from_numpy(codes), table, ks, T, U, Wc)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)
    assert (want[-3:] == 0).all()  # no windows: type 0, no counts


def _set_rows(rng, pool, n_rows, width):
    """Sorted SENTINEL-padded rows drawn with replacement, plus lens."""
    sk = np.full((n_rows, width), SENT, dtype=np.uint64)
    lens = rng.integers(0, width + 1, n_rows).astype(np.int32)
    for r in range(n_rows):
        sk[r, : lens[r]] = np.sort(rng.choice(pool, size=lens[r]))
    return sk, lens


def test_set_probe_plain_matches_the_jax_chain():
    """hpv16_comb_stage1's ranks and bucket indices -> row gather ->
    hpv16_comb_finish vs set_probe_plain: duplicates (occ > 0 misses),
    tied types (types 1 and 2 hold the same set), all-zero rows."""
    rng = np.random.default_rng(12)
    pool = rng.integers(1, 2**64 - 1, size=300, dtype=np.uint64)
    assert (pool >= 2**63).any()
    ref_rows = [rng.choice(pool, 120) for _ in range(40)]
    ref_rows[2] = ref_rows[1]
    T, U = 30, 10
    pt = jlookup.build_set_table(ref_rows, num_refs=T + U)
    got_pt = lookup.build_set_table([r.view(np.int64) for r in ref_rows], num_refs=T + U)
    assert np.array_equal(got_pt.table, pt.table)

    full, lens = _set_rows(rng, np.concatenate([pool, rng.integers(1, 2**63, 50, np.uint64)]),
                           24, 64)
    full[3, : lens[3]] = np.sort(ref_rows[1][: lens[3]])  # a read tied between types 1, 2
    occ = np.asarray(jintersect.occ_ranks(full)).astype(np.uint32)
    qmask = (np.arange(64)[None, :] < lens[:, None]) & (full != SENT)
    lo, hi = full.astype(np.uint32), (full >> np.uint64(32)).astype(np.uint32)
    rows = pt.table[np.asarray(jlookup.bucket_indices(lo, hi, occ, pt.table.shape[0]))]
    want = np.asarray(jengine.hpv16_comb_finish(jnp.asarray(rows), lo, hi, occ, qmask,
                                                num_types=T, num_uniq=U))
    table = torch.from_numpy(pt.table.view(np.int32))
    got = set_probe(torch.from_numpy(full.view(np.int64)), torch.from_numpy(lens), table, T, U)
    assert np.array_equal(got.numpy(), want)
    assert want[3, 0] == 1 and want[:, 1].max() > 1 and (want[lens == 0] == 0).all()


def test_set_probe_kernel_wrapper_rejects_what_it_cannot_take():
    logical = torch.zeros((4, 2 * (3 + 2)), dtype=torch.int32)
    table = pack_set_table(logical, 40)
    rows, lens = torch.zeros((2, 8), dtype=torch.int64), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64 rows"):
        _set_probe_cuda(rows.int(), lens, table, 30, 10)
    with pytest.raises(ValueError, match="PackedSetTable"):  # the kernel never repacks
        _set_probe_cuda(rows, lens, logical, 30, 10)
    with pytest.raises(ValueError, match="power of two"):
        _set_probe_cuda(rows, lens, pack_set_table(torch.zeros((3, 10), dtype=torch.int32), 40),
                        30, 10)
    with pytest.raises(ValueError, match="lens"):
        _set_probe_cuda(rows, lens[:1], table, 30, 10)
    with pytest.raises(ValueError, match=">= 1 type"):
        _set_probe_cuda(rows, lens, table, 0, 10)
    with pytest.raises(ValueError, match="do not fit"):
        _set_probe_cuda(rows, lens, table, 60, 10)


@pytest.mark.parametrize("ks", [(5,), (3, 7, 40)])
def test_window_mask_and_hash_batch_match_jax(ks):
    rng = np.random.default_rng(len(ks))
    lens = np.array([0, 2, 5, 17, 32, 33], dtype=np.int32)
    codes = rng.integers(0, 4, (6, 32)).astype(np.uint8)
    got = window_mask(torch.from_numpy(lens), 32, ks)
    assert np.array_equal(got.numpy(), np.asarray(jax_window_mask(lens, 32, ks)))
    h, m = engine.hash_batch_with_mask(torch.from_numpy(codes), torch.from_numpy(lens), ks)
    jh, jm = jengine.hash_batch_with_mask(codes, lens, ks)
    assert np.array_equal(h.numpy().view(np.uint64), np.asarray(jh))
    assert np.array_equal(m.numpy(), np.asarray(jm))


def test_compact_width_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        L = int(rng.integers(1, 3000))
        ks = tuple(int(k) for k in rng.integers(1, 40, rng.integers(1, 4)))
        lens = rng.integers(0, L + 1, rng.integers(1, 9))
        grid = int(rng.choice([1, 4, 8]))
        assert engine.hpv16_compact_width(lens, L, ks, grid) == \
            jengine.hpv16_compact_width(lens, L, ks, grid)


def test_slot_policies_and_projected_bytes_match_jax():
    for n in (0, 7, 1000, 100_000, 1_200_000, 1_440_000):
        for refs in (5, 40, 196):
            wm = (refs + 31) // 32
            for policy in ("narrow", "compact"):
                assert lookup.pick_slots(n, wm, policy) == jlookup.pick_slots(n, wm, policy=policy)
            assert lookup.projected_table_bytes(n, refs) == jlookup.projected_table_bytes(n, refs)
    assert lookup.projected_table_bytes(1_440_000, 196) == 480 << 20  # S=12, 2**20 buckets


def test_build_set_table_matches_jax():
    rng = np.random.default_rng(8)
    pool = rng.integers(0, 2**64 - 1, size=500, dtype=np.uint64)
    pool[:3] = (0, 2**63, 2**64 - 2)
    rows = [rng.choice(pool, int(n)) for n in rng.integers(0, 200, 37)]  # duplicates, zeros
    want = jlookup.build_set_table(rows)
    got = lookup.build_set_table([r.view(np.int64) for r in rows])
    assert got.num_refs == want.num_refs == 37
    assert np.array_equal(got.table, want.table)


@pytest.mark.parametrize("groups", [[[0, 1], [2], [3, 4, 5]], [[0, 1, 2]]])
def test_family_unique_matches_jax(groups):
    rng = np.random.default_rng(len(groups))
    pool = rng.integers(1, 2**64 - 1, size=60, dtype=np.uint64)
    pool[0] = 0
    R = max(r for g in groups for r in g) + 1
    hashes = rng.choice(pool, size=(R, 40))
    mask = rng.random((R, 40)) < 0.8
    jh, jm = jcmd._family_unique(jnp.asarray(hashes), jnp.asarray(mask), groups)
    gh, gm = hpv16_cmd._family_unique(torch.from_numpy(hashes.view(np.int64)),
                                      torch.from_numpy(mask), groups)
    assert np.array_equal(gm.numpy(), np.asarray(jm))
    assert np.array_equal(gh.numpy().view(np.uint64), np.asarray(jh))
    assert gm.any()


def test_synth_hpv16_refpath_and_reads(tmp_path):
    panel = synth.write_hpv16_refpath(str(tmp_path), seed=1, num_types=20, genome_len=1000)
    assert panel.type_names[15] == "HPV16REF" and len(panel.subs) == 10
    assert os.path.getsize(tmp_path / "all_pave_ref.fa") > 20 * 800
    with open(tmp_path / "new_refs.fa") as fh:
        assert [ln[1:3] for ln in fh if ln[0] == ">"] == list(synth.HPV16_SUBLINEAGES)
    div = [np.mean(s != panel.types[15]) for s in panel.subs]
    assert 0.004 < np.mean(div) < 0.02
    reads, truth = synth.make_nanopore_reads(200, 2, panel)
    lens = np.array([len(r) for r in reads])
    assert lens.min() >= 500 and lens.max() <= 20000 and 3000 < lens.mean() < 6000
    assert 0.6 < np.mean(np.array(truth) == "HPV16REF") < 0.95
    again, _ = synth.make_nanopore_reads(200, 2, synth.make_hpv16_panel(1, 20, 1000))
    assert all(np.array_equal(a, b) for a, b in zip(reads, again))
