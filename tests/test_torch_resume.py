"""`--resume` of the port against rkmh-tpu's, for stream, hpv16, hash,
search (line-counted) and filter (the ``.progress`` sidecar).

For each command an uninterrupted ``-o`` run of rkmh-tpu gives the
expected bytes.  A partial output is then made as an interrupted run
leaves it: the expected bytes cut mid-line at about 40% (line-counted), or
cut at one of the run's own sidecar saves plus a torn tail of the next
chunk, with that save as the sidecar (filter).  The port resumes it with
--resume at two --chunk-reads values (neither the one that made the
partial output), and the result must equal the uninterrupted bytes; so
must rkmh-tpu's resume of a partial output the port made.  Inputs are
synthetic (rkmh_tpu_torch.synth, made from a seed), with reads shorter
than k (hash writes ``name\\t``, search nothing) and, for stream, a -M
counter pass, which must still count every read.  Also: the refusals
(--resume without -o, with -i, of -K and the JSON dumps, a missing
sidecar, an output shorter than its sidecar), ``count_complete_lines``
and ``skip_reads`` over the native reader's chunks and the Python
parser's.  The port runs its plain path on the CPU.  Tolerance: none.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from rkmh_tpu.commands import filter_cmd as jfilter
from rkmh_tpu.commands import hash_cmd as jhash
from rkmh_tpu.commands import hpv16_cmd as jhpv16
from rkmh_tpu.commands import recovery as jrecovery
from rkmh_tpu.commands import search_cmd as jsearch
from rkmh_tpu.commands import stream as jstream
from rkmh_tpu.commands.common import iter_packed_chunks as jax_chunks
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands import filter_cmd, hash_cmd, hpv16_cmd, recovery, search_cmd, stream
from rkmh_tpu_torch.commands.common import iter_packed_chunks

CHUNKS = (7, 0)  # the resumed runs' --chunk-reads; the partial outputs use 11


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume")
    refs, short, _, _ = synth.write_workload(str(d), 60, 150, num_refs=4, genome_len=1500,
                                             seed=13, n_rate=0.02)
    names, genomes = synth.make_panel(4, 1500, seed=13)
    reads, _ = synth.make_reads(genomes, 30, 300, seed=14)
    lens = np.random.default_rng(15).integers(0, 300, 30)
    lens[[0, 9, 10, 20]] = (0, 5, 11, 3)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(reads, lens)):
            fh.write(f">q{i}\n{r[:n].tobytes().decode()}\n")
    ascii_g = synth._ACGTN[genomes]
    kmers = str(d / "kmers.txt")
    with open(kmers, "w") as fh:
        for p in range(0, 1400, 9):
            fh.write(ascii_g[p % 4, p: p + 12].tobytes().decode() + "\n")
    hp = synth.write_hpv16_refpath(str(d / "hpv16"), seed=3, num_types=8, genome_len=1500)
    hp_reads, _ = synth.make_nanopore_reads(30, 5, hp, mean_len=900, min_len=200, max_len=2000)
    hp_fq = str(d / "hpv16.fq")
    synth.write_fastq_records(hp_fq, hp_reads)
    return {"refs": refs, "short": short, "mixed": mixed, "kmers": kmers,
            "hpv16": str(d / "hpv16"), "hpv16_reads": hp_fq}


def _config(command, pkg, data, **kw):
    """(run, config) of `command` in rkmh-tpu (pkg "jax") or the port."""
    port = pkg == "torch"
    extra = {"device": "cpu"} if port else {}
    if command == "stream":
        mod = stream if port else jstream
        return mod.run, mod.StreamConfig(ref_files=[data["refs"]], read_files=[
            data["short"], data["mixed"]], ks=(12,), min_kmer_occ=2, counter_size=4099,
            batch_size=8, **kw, **extra)
    if command == "hpv16":
        mod = hpv16_cmd if port else jhpv16
        return mod.run, mod.Hpv16Config(read_files=[data["hpv16_reads"]], refpath=data["hpv16"],
                                        ks=(16,), batch_size=8, **kw, **extra)
    if command == "hash":
        mod = hash_cmd if port else jhash
        return mod.run, mod.HashConfig(read_files=[data["mixed"], data["short"]], ks=(12, 16),
                                       batch_size=8, **kw, **extra)
    if command == "search":
        mod = search_cmd if port else jsearch
        return mod.run, mod.SearchConfig(ref_files=[data["kmers"]],
                                         read_files=[data["mixed"], data["short"]], ks=(12,),
                                         batch_size=8, **kw, **extra)
    mod = filter_cmd if port else jfilter
    return mod.run, mod.FilterConfig(ref_files=[data["refs"]], read_files=[
        data["short"], data["mixed"]], ks=(12,), min_matches=8, batch_size=8, **kw, **extra)


def _run(command, pkg, data, out_file, chunk_reads, resume=False):
    fn, cfg = _config(command, pkg, data, out_file=out_file, chunk_reads=chunk_reads,
                      resume=resume)
    return fn(cfg)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # hpv16 writes its .tst side file here
    return tmp_path


def _cut_mid_line(full: bytes) -> bytes:
    at = int(len(full) * 0.4)
    while full[at - 1: at] == b"\n" or full[at: at + 1] == b"\n":
        at += 1
    return full[:at]


LINE_COUNTED = ["stream", "hpv16", "hash", "search"]


@pytest.mark.parametrize("chunk_reads", CHUNKS)
@pytest.mark.parametrize("command", LINE_COUNTED)
def test_line_counted_resume_equals_an_uninterrupted_run(data, in_tmp, command, chunk_reads):
    want_path = str(in_tmp / "want.txt")
    assert _run(command, "jax", data, want_path, 11) == 0
    full = Path(want_path).read_bytes()
    assert full.count(b"\n") > 20
    for maker, resumer in (("jax", "torch"), ("torch", "jax")):
        part = str(in_tmp / f"{maker}.txt")
        assert _run(command, maker, data, part, 11) == 0
        assert Path(part).read_bytes() == full
        with open(part, "r+b") as fh:
            fh.truncate(len(_cut_mid_line(full)))
        assert _run(command, resumer, data, part, chunk_reads, resume=True) == 0
        assert Path(part).read_bytes() == full, f"{resumer} resuming {maker}'s output"
        # resuming a finished output appends nothing
        assert _run(command, "torch", data, part, chunk_reads, resume=True) == 0
        assert Path(part).read_bytes() == full


def _filter_saves(data, path, monkeypatch, chunk_reads):
    saves = []
    orig = recovery.Progress.save

    def record(self, reads, nbytes):
        saves.append((reads, nbytes))
        orig(self, reads, nbytes)

    monkeypatch.setattr(recovery.Progress, "save", record)
    assert _run("filter", "torch", data, path, chunk_reads) == 0
    monkeypatch.setattr(recovery.Progress, "save", orig)
    return saves


@pytest.mark.parametrize("chunk_reads", CHUNKS)
def test_filter_resume_from_its_sidecar_equals_an_uninterrupted_run(data, in_tmp, monkeypatch,
                                                                    chunk_reads):
    want_path = str(in_tmp / "want.fq")
    assert _run("filter", "jax", data, want_path, 11) == 0
    full = Path(want_path).read_bytes()
    path = str(in_tmp / "out.fq")
    saves = _filter_saves(data, path, monkeypatch, 11)
    assert Path(path).read_bytes() == full and len(saves) == 9  # 60 + 30 reads, chunks of 11
    assert json.loads(Path(path + ".progress").read_text()) == {"reads": 90, "bytes": len(full)}
    reads, nbytes = saves[len(saves) // 2]
    assert 0 < nbytes < len(full)
    for resumer in ("torch", "jax"):
        with open(path, "wb") as fh:  # the save's bytes, then a torn tail of the next chunk
            fh.write(full[: nbytes + 37])
        with open(path + ".progress", "w") as fh:
            json.dump({"reads": reads, "bytes": nbytes}, fh)
        assert _run("filter", resumer, data, path, chunk_reads, resume=True) == 0
        assert Path(path).read_bytes() == full, resumer
        assert json.loads(Path(path + ".progress").read_text()) == {"reads": 90, "bytes": len(full)}


def test_filter_resume_refusals_match_jax(data, in_tmp, capsys):
    path = str(in_tmp / "out.fq")
    assert _run("filter", "torch", data, path, 11) == 0
    with open(path, "r+b") as fh:
        fh.truncate(10)  # shorter than the sidecar says
    errs = []
    for pkg in ("jax", "torch"):
        capsys.readouterr()
        assert _run("filter", pkg, data, path, 11, resume=True) == 1
        errs.append([ln for ln in capsys.readouterr().err.splitlines() if "--resume" in ln])
    os.remove(path + ".progress")
    for pkg in ("jax", "torch"):
        assert _run("filter", pkg, data, path, 11, resume=True) == 1
        errs.append([ln for ln in capsys.readouterr().err.splitlines() if "--resume" in ln])
    assert errs[0] == errs[1] and errs[2] == errs[3] and "shorter" in errs[0][0]
    assert "no readable progress sidecar" in errs[2][0]


@pytest.mark.parametrize("command,kw", [
    ("stream", {}), ("hpv16", {}), ("hash", {}), ("search", {}), ("filter", {}),
    ("stream", {"out_file": "o.txt", "in_stream": True}),
    ("filter", {"out_file": "o.txt", "in_stream": True}),
    ("hash", {"out_file": "o.txt", "output_kmers": True}),
    ("hash", {"out_file": "o.txt", "json_out": True}),
], ids=["stream", "hpv16", "hash", "search", "filter", "stream-i", "filter-i", "hash-K",
        "hash-json"])
def test_resume_refusals_match_jax(data, in_tmp, capsys, command, kw):
    errs = []
    for pkg in ("jax", "torch"):
        capsys.readouterr()
        fn, cfg = _config(command, pkg, data, resume=True, **kw)
        assert fn(cfg) == 1
        errs.append([ln for ln in capsys.readouterr().err.splitlines() if "--resume" in ln])
    assert errs[0] == errs[1] and len(errs[0]) == 1
    assert not os.path.exists("o.txt")


def test_count_complete_lines_cuts_a_torn_line_as_jax(tmp_path):
    for mod in (jrecovery, recovery):
        path = tmp_path / f"{mod.__name__}.txt"
        path.write_bytes(b"a\tb\nc\td\nhalf a li")
        assert mod.count_complete_lines(str(path)) == 2
        assert path.read_bytes() == b"a\tb\nc\td\n"


@pytest.mark.parametrize("skip", [0, 5, 11, 12, 30, 89, 90, 95])
def test_skip_reads_slices_native_and_python_chunks_as_jax(data, skip):
    files = [data["short"], data["mixed"]]

    def reads(chunks):
        return [(n, s, int(ln)) for c in chunks for n, s, ln in zip(c.names, c.seqs, c.lens)]

    want = reads(jrecovery.skip_reads(jax_chunks(files, 11), skip))
    assert reads(recovery.skip_reads(iter_packed_chunks(files, 11), skip)) == want
    with open(data["short"], "rb") as a, open(data["mixed"], "rb") as b:
        py = list(recovery.skip_reads(iter_packed_chunks([a, b], 11), skip))
    assert reads(py) == want and len(want) == max(90 - skip, 0)
    for c in py:  # the codes of a sliced chunk are the rows of its reads
        for i, s in enumerate(c.seqs):
            assert c.codes[i, : len(s)].tolist() == [
                "ACGT".find(chr(b)) if chr(b) in "ACGT" else 4 for b in s]
