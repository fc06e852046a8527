"""`hpv16 --devices N [--tp T]` of the port against rkmh-tpu's.

rkmh-tpu runs ``hpv16_cmd.run`` on the 8 virtual CPU devices
tests/conftest.py gives JAX; the port runs with ``mesh_devices = (cpu,) *
8``, where every kernel is its plain version, on the refpath of
``synth.write_hpv16_refpath`` (12 types x 2 kb, 4 lineages, 10
sublineages: T + U = 26 combined columns) and 40 nanopore-like reads.
Tolerance: none; lines, the .tst side file and the logged fallback lines
must be equal byte for byte.

* (dp, tp) = (4, 1), (2, 2), (1, 4) and (2, 4) (at tp = 4 the 26 columns
  pad to 28: two pad columns at the end); -M 2 at (2, 2) with counter
  sizes 4096 and 4104; the sorted-key fallback (RKMH_TPU_SET_TABLE_MAX_MB=0)
  at (2, 2); -o --resume at (2, 2); each fallback reason's logged line;
  --tp 2 without --devices (one device, as in rkmh-tpu);
* the port's ``build_sharded_set_tables_device`` against rkmh-tpu's: the
  same [tp, NB, width] tables bit for bit, and so the same counts per shard
  on the same queries;
* ``set_probe_partial_plain`` on every shard merged by
  ``merge_hpv16_partials`` against ``set_probe_plain`` on the whole table
  (hypothesis: tied types on both sides of a shard border, reads that share
  nothing, tp from 1 to 7), on the logical and on the packed shard tables.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rkmh_tpu.commands import hpv16_cmd as jcmd
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands import hpv16_cmd
from rkmh_tpu_torch.ops.lookup import build_set_table, build_sharded_set_tables_device
from rkmh_tpu_torch.ops.set_probe import (
    _logical_counts,
    _set_probe_partial_cuda,
    merge_hpv16_partials,
    pack_set_table,
    set_probe_partial,
    set_probe_partial_plain,
    set_probe_plain,
)
from rkmh_tpu_torch.ops.sketch import bottom_s_sketch

GRID = (torch.device("cpu"),) * 8  # as many entries as JAX's virtual devices
SMALL = dict(num_types=12, genome_len=2000)
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("hpv16_sharded")
    panel = synth.write_hpv16_refpath(str(d / "refs"), seed=3, **SMALL)
    reads, _ = synth.make_nanopore_reads(40, 5, panel, mean_len=1200, min_len=300,
                                         max_len=3000, n_rate=0.01)
    synth.write_fastq_records(str(d / "reads.fq"), reads)
    return {"refs": str(d / "refs"), "reads": str(d / "reads.fq"), "panel": panel}


def _run(mod, tmp_path, monkeypatch, name, data, **kw):
    """-> (stdout or None with -o, the .tst file's text)."""
    wd = tmp_path / name
    wd.mkdir()
    monkeypatch.chdir(wd)  # the .tst side file lands in the working directory
    extra = {"device": "cpu", "mesh_devices": GRID} if mod is hpv16_cmd else {}
    buf = None if kw.get("out_file") else io.StringIO()
    assert mod.run(mod.Hpv16Config(read_files=[data["reads"]], refpath=data["refs"], ks=(16,),
                                   batch_size=8, **kw, **extra), out=buf) == 0
    return (None if buf is None else buf.getvalue(),
            (wd / "lineage_specific_hashes.16.tst").read_text())


def _both(tmp_path, monkeypatch, data, **kw):
    want = _run(jcmd, tmp_path, monkeypatch, "jax", data, **kw)
    got = _run(hpv16_cmd, tmp_path, monkeypatch, "torch", data, **kw)
    return want, got


@pytest.mark.parametrize("dp,tp", [(4, 1), (2, 2), (1, 4), (2, 4)])
def test_sharded_hpv16_byte_identical_to_jax(data, tmp_path, monkeypatch, dp, tp):
    want, got = _both(tmp_path, monkeypatch, data, devices=dp * tp, tp=tp)
    assert got == want
    lines = want[0].splitlines()
    assert len(lines) == 40 and any(int(ln.split("\t")[2].split("/")[0]) > 0 for ln in lines)
    one = _run(hpv16_cmd, tmp_path, monkeypatch, "one", data)
    assert one == got
    if tp == 4:  # 12 types + 14 groups pad to 28 columns: the pads never win
        tb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(refpath=data["refs"], tst_file=False),
                                    (16,), torch.device("cpu"), tp_shards=tp)
        assert len(tb.type_names) + tb.n_lin + tb.n_sub == 26 and tb.rps * tp == 28
        assert tb.shard_tables.shape[0] == tp and tb.comb_table is None


@pytest.mark.parametrize("size", [4096, 4104])
def test_sharded_hpv16_M_byte_identical_to_jax(data, tmp_path, monkeypatch, size):
    want, got = _both(tmp_path, monkeypatch, data, devices=4, tp=2, min_kmer_occ=2,
                      counter_size=size)
    assert got == want
    plain = _run(hpv16_cmd, tmp_path, monkeypatch, "plain", data, devices=4, tp=2)
    assert plain[0] != got[0]  # the counter changed what the reads share


def test_sharded_hpv16_sorted_fallback_byte_identical(data, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("RKMH_TPU_SET_TABLE_MAX_MB", "0")
    want, got = _both(tmp_path, monkeypatch, data, devices=4, tp=2)
    assert got == want
    err = capsys.readouterr().err
    assert err.count("using the sorted-key panel") == 2
    monkeypatch.delenv("RKMH_TPU_SET_TABLE_MAX_MB")
    assert _run(hpv16_cmd, tmp_path, monkeypatch, "table", data, devices=4, tp=2) == got


def test_sharded_hpv16_resume_byte_identical(data, tmp_path, monkeypatch):
    full = str(tmp_path / "full.tsv")
    want = _run(jcmd, tmp_path, monkeypatch, "jax", data, devices=4, tp=2, min_kmer_occ=2,
                counter_size=4096, out_file=full)
    text = open(full).read()
    out = str(tmp_path / "cut.tsv")
    with open(out, "w") as fh:  # an interrupted run: 13 lines and a torn one
        lines = text.splitlines(keepends=True)
        fh.write("".join(lines[:13]) + lines[13][:20])
    got = _run(hpv16_cmd, tmp_path, monkeypatch, "torch", data, devices=4, tp=2,
               min_kmer_occ=2, counter_size=4096, out_file=out, resume=True)
    assert open(out).read() == text
    assert got[1] == want[1]


@pytest.mark.parametrize("kw,reason", [
    (dict(devices=3, tp=2), "--devices 3 is not divisible by --tp 2"),
    (dict(devices=16, tp=2), "--devices 16 > 8 visible device(s)"),
    (dict(devices=4, tp=2, min_kmer_occ=2, counter_size=4099),
     "-M counter size 4099 is not divisible by the 2 dp shards"),
    (dict(devices=4, tp=0), "--devices 4 is not divisible by --tp 0"),
], ids=["tp", "visible", "counter", "tp0"])
def test_fallback_lines_match_jax(data, tmp_path, monkeypatch, capsys, kw, reason):
    want = _run(jcmd, tmp_path, monkeypatch, "jax", data, **kw)
    jax_err = capsys.readouterr().err
    got = _run(hpv16_cmd, tmp_path, monkeypatch, "torch", data, **kw)
    err = capsys.readouterr().err
    line = f"hpv16 --devices ignored ({reason}); running single-device"
    assert [ln for ln in jax_err.splitlines() if "ignored" in ln] == [line]
    assert [ln for ln in err.splitlines() if "ignored" in ln] == [line]
    assert got == want


@pytest.mark.parametrize("devices", [0, 1])
def test_tp_without_devices_runs_single_device(data, tmp_path, monkeypatch, capsys, devices):
    want = _run(jcmd, tmp_path, monkeypatch, "jax", data, devices=devices, tp=2)
    got = _run(hpv16_cmd, tmp_path, monkeypatch, "torch", data, devices=devices, tp=2)
    assert got == want
    assert "ignored" not in capsys.readouterr().err


# ---- the shard tables


def _rows(seed, R, pool_size=3000, n=400):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**64 - 1, size=pool_size, dtype=np.uint64)
    pool[:2] = (0, 2**63)  # zeros drop, hashes >= 2**63 stay
    return rng, pool, [rng.choice(pool, int(rng.integers(0, n))) for _ in range(R)]


def _padded(rows, tp):
    """Per-reference hash arrays -> ([R', W] int64 hashes, mask), R' the
    next multiple of tp (pad rows masked, at the end, as hpv16 pads)."""
    R = len(rows) + (-len(rows)) % tp
    W = max([1, *map(len, rows)])
    h = np.zeros((R, W), np.uint64)
    m = np.zeros(h.shape, bool)
    for i, r in enumerate(rows):
        h[i, : len(r)], m[i, : len(r)] = r, True
    return h, m


def _sharded(rows, tp):
    h, m = _padded(rows, tp)
    return build_sharded_set_tables_device(torch.from_numpy(h.view(np.int64)),
                                           torch.from_numpy(m), tp)


def _queries(rng, pool, B=24, width=300):
    sk = np.full((B, width), SENT, dtype=np.uint64)
    lens = rng.integers(0, width + 1, B).astype(np.int32)
    extra = rng.integers(1, 2**64 - 1, size=200, dtype=np.uint64)
    for r in range(B):
        sk[r, : lens[r]] = np.sort(rng.choice(np.concatenate([pool, extra]), lens[r]))
    return torch.from_numpy(sk.view(np.int64)), torch.from_numpy(lens)


@pytest.mark.parametrize("R,tp", [(26, 1), (26, 2), (26, 4), (40, 3)])
def test_sharded_set_tables_match_jax(R, tp):
    rng, pool, rows = _rows(R + tp, R)
    h, m = _padded(rows, tp)
    want, want_rps = jlookup.build_sharded_set_tables_device(jnp.asarray(h), jnp.asarray(m), tp)
    want = np.array(want)
    got, rps = _sharded(rows, tp)
    assert (rps, tuple(got.shape), got.dtype) == (want_rps, want.shape, torch.int32)
    assert np.array_equal(got.numpy(), want.view(np.int32))
    q, ql = _queries(rng, pool)
    for j in range(tp):
        counts = _logical_counts(q, ql, got[j], rps)
        assert torch.equal(counts, _logical_counts(
            q, ql, torch.from_numpy(want[j].view(np.int32)), rps))
        assert counts.any() or j * rps >= R


# ---- the partial epilogue and the merge


@st.composite
def _panel(draw):
    T = draw(st.integers(1, 9))
    U = draw(st.integers(0, 6))
    tp = draw(st.integers(1, 7))
    seed = draw(st.integers(0, 2**16))
    return T, U, tp, seed


@settings(max_examples=60, deadline=None)
@given(_panel())
def test_partials_merge_equals_the_whole_table(case):
    T, U, tp, seed = case
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**64 - 1, size=40, dtype=np.uint64)  # small: ties everywhere
    rows = [rng.choice(pool, int(rng.integers(0, 12))) for _ in range(T + U)]
    if T > 1:
        rows[1] = rows[0]  # a tie on every border that splits types 0 and 1
    q, ql = _queries(rng, pool, B=12, width=16)
    whole = set_probe_plain(q, ql, torch.from_numpy(
        build_set_table(rows, num_refs=T + U).table.view(np.int32)), T, U)
    tables, rps = _sharded(rows, tp)
    parts, packed_parts = [], []
    for j in range(tp):
        shard = tables[j]
        part = set_probe_partial_plain(q, ql, shard, j * rps, rps, T, U)
        if j * rps >= T:  # a shard without type columns
            assert (part[:, :2] == -1).all()
        parts.append(part)
        packed_parts.append(set_probe_partial(q, ql, pack_set_table(shard, rps), j * rps, rps,
                                              T, U))
    assert torch.equal(merge_hpv16_partials(torch.stack(parts)), whole)
    assert torch.equal(torch.stack(packed_parts), torch.stack(parts))
    assert (whole[ql == 0] == 0).all()  # a read that shares nothing: type 0, 0, no counts


def test_merge_picks_the_first_shard_holding_the_max():
    # two shards of 3 columns: types 0-3, groups 4-5; the max 2 in columns 1 and 3
    parts = torch.tensor([[[1, 2, 0, 0]], [[3, 2, 5, 1]]], dtype=torch.int64)
    assert merge_hpv16_partials(parts).tolist() == [[1, 2, 5, 1]]
    parts[0, 0, 1] = 1
    assert merge_hpv16_partials(parts).tolist() == [[3, 2, 5, 1]]
    parts = torch.tensor([[[0, 0, 0, 0]], [[-1, -1, 0, 4]]], dtype=torch.int64)
    assert merge_hpv16_partials(parts).tolist() == [[0, 0, 0, 4]]


def test_partial_kernel_wrapper_rejects_what_it_cannot_take():
    logical = torch.zeros((4, 2 * (3 + 1)), dtype=torch.int32)
    packed = pack_set_table(logical, 20)
    rows, lens = bottom_s_sketch(torch.zeros((2, 8), dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="col0 >= 0"):
        _set_probe_partial_cuda(rows, lens, packed, -1, 20, 30, 10)
    with pytest.raises(ValueError, match="40 references do not fit 1 mask words"):
        _set_probe_partial_cuda(rows, lens, packed, 0, 40, 30, 10)
    with pytest.raises(ValueError, match="PackedSetTable"):
        _set_probe_partial_cuda(rows, lens, logical, 0, 20, 30, 10)
