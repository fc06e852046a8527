"""Sketch JSON interop of the port against rkmh-tpu's: files, panels, and
`stream`/`filter --ref-sketches` (and `-R`).

The port's ``io/sketch_json`` must write the same bytes as rkmh-tpu's
(the rkmh dump and sourmash signatures, hashes >= 2**63 included), load
the same records from every schema (the repo's sourmash fixture
``tests/fixtures/sourmash_hpv16_slices.sig``, a ``hash -o`` dump of either
package, and a ``mash info -d``-shaped dump written here) and build the
same panel bits.  Then ``stream`` and ``filter`` run with those files as
``--ref-sketches`` (or ``-R``) in both packages, at a sketch size below
the records' (each record cut) and at the records' own, on synthetic reads
(rkmh_tpu_torch.synth, made from a seed); and the round trip ``hash -r
refs -s S -o P`` then ``stream --ref-sketches P.rkmh.json`` equals
``stream -r refs``.  The port runs its plain path on the CPU.  Tolerance:
none.
"""

import io
import json

import numpy as np
import pytest

from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.filter_cmd import FilterConfig as JaxFilterConfig
from rkmh_tpu.commands.filter_cmd import run as jax_filter
from rkmh_tpu.commands.hash_cmd import HashConfig as JaxHashConfig
from rkmh_tpu.commands.hash_cmd import run as jax_hash
from rkmh_tpu.commands.stream import StreamConfig as JaxStreamConfig
from rkmh_tpu.commands.stream import run as jax_stream
from rkmh_tpu.io import sketch_json as jsj
from rkmh_tpu.utils import to_host
from rkmh_tpu_torch import cli, synth
from rkmh_tpu_torch.commands.filter_cmd import FilterConfig, run as filter_run
from rkmh_tpu_torch.commands.hash_cmd import HashConfig, run as hash_run
from rkmh_tpu_torch.commands.stream import StreamConfig, run as stream_run
from rkmh_tpu_torch.io import sketch_json as sj

FIXTURE = "tests/fixtures/sourmash_hpv16_slices.sig"


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("sketches")
    refs, reads, _, _ = synth.write_workload(str(d), 120, 150, num_refs=5, genome_len=1800,
                                             seed=12)
    files = {"refs": refs, "reads": reads, "fixture": FIXTURE}
    for name, fn, cfg, extra in (("jax_dump", jax_hash, JaxHashConfig, {}),
                                 ("torch_dump", hash_run, HashConfig, {"device": "cpu"})):
        assert fn(cfg(read_files=[refs], ks=(12,), sketch_size=300,
                      out_prefix=str(d / name), **extra), out=io.StringIO()) == 0
        files[name] = str(d / f"{name}.rkmh.json")
    with open(files["torch_dump"]) as fh:
        recs = json.load(fh)
    mash = {"kmer": 12, "alphabet": "ACGT", "preserveCase": False, "canonical": True,
            "sketchSize": 300, "hashType": "MurmurHash3_x64_128", "hashBits": 64,
            "hashSeed": 42, "sketches": [{"name": r["name"], "length": 1800,
                                          "comment": "", "hashes": r["sketches"][::-1]}
                                         for r in recs]}
    files["mash"] = str(d / "mash.json")
    with open(files["mash"], "w") as fh:
        json.dump(mash, fh)
    return files


def _records(path, mod):
    with open(path) as fh:
        return mod.load_sketches(fh)


@pytest.mark.parametrize("source", ["fixture", "jax_dump", "torch_dump", "mash"])
def test_load_sketches_matches_jax(workload, source):
    got, want = _records(workload[source], sj), _records(workload[source], jsj)
    assert [vars(r) for r in got] == [vars(r) for r in want] and got
    assert all(r.hashes == sorted(r.hashes) for r in got)


def test_dumps_write_jax_bytes():
    rng = np.random.default_rng(2)
    recs = [(f"r{i}|x", sorted(int(h) for h in rng.integers(1, 2**64 - 1, 30, dtype=np.uint64)),
             [16], 30, 1000 + i) for i in range(3)]
    assert any(h >= 2**63 for r in recs for h in r[1])
    for dump in ("dump_sketches", "dump_sourmash"):
        want, got = io.StringIO(), io.StringIO()
        getattr(jsj, dump)([jsj.SketchRecord(*r) for r in recs], want)
        getattr(sj, dump)([sj.SketchRecord(*r) for r in recs], got)
        assert got.getvalue() == want.getvalue()
    with pytest.raises(ValueError, match="multi-k"):
        sj.dump_sourmash([sj.SketchRecord("m", [1, 2], [12, 16], 2)], io.StringIO())


@pytest.mark.parametrize("source,sketch_size", [("fixture", None), ("torch_dump", 100),
                                                ("mash", 300), ("jax_dump", 0)])
def test_panel_from_sketches_matches_jax(workload, source, sketch_size):
    got = sj.panel_from_sketches(_records(workload[source], sj), sketch_size, "cpu")
    want = jsj.panel_from_sketches(_records(workload[source], jsj), sketch_size)
    assert got.keys == want.keys
    assert np.array_equal(got.sketches.numpy().view(np.uint64), to_host(want.sketches))
    assert np.array_equal(got.lens.numpy(), to_host(want.lens))
    assert np.array_equal(got.table.numpy().view(np.uint32), to_host(want.table[0]))


def test_foreign_sketches_are_refused_as_jax_refuses():
    bad = io.StringIO(json.dumps({"hashBits": 32, "hashSeed": 42, "kmer": 12,
                                  "sketches": [{"name": "x", "hashes": [1, 2]}]}))
    with pytest.raises(ValueError, match="hashBits 32"):
        sj.load_sketches(bad)
    seed = io.StringIO(json.dumps({"class": "sourmash_signature", "signatures": [
        {"ksize": 21, "seed": 7, "mins": [1]}]}))
    with pytest.raises(ValueError, match="seed 7"):
        sj.load_sketches(seed)


@pytest.mark.parametrize("source,kw", [
    ("fixture", dict(ks=(21,), sketch_size=20)),
    ("jax_dump", dict(ks=(12,), sketch_size=300)),
    ("torch_dump", dict(ks=(12,), sketch_size=100, min_matches=5, min_diff=1)),
    ("mash", dict(ks=(12,), sketch_size=300, batch_size=16, chunk_reads=50)),
], ids=["sourmash-fixture", "jax-hash-dump", "torch-hash-dump-cut", "mash-dump"])
def test_stream_ref_sketches_matches_jax(workload, source, kw):
    want, got = io.StringIO(), io.StringIO()
    assert jax_stream(JaxStreamConfig(ref_sketches=workload[source],
                                      read_files=[workload["reads"]], **kw), out=want) == 0
    assert stream_run(StreamConfig(ref_sketches=workload[source], read_files=[workload["reads"]],
                                   device="cpu", **kw), out=got) == 0
    assert got.getvalue() == want.getvalue() and len(want.getvalue().splitlines()) == 120


@pytest.mark.parametrize("source", ["fixture", "torch_dump"])
def test_filter_ref_sketches_matches_jax(workload, source):
    kw = dict(ks=(21,) if source == "fixture" else (12,), sketch_size=300, min_matches=3)
    want, got = io.StringIO(), io.StringIO()
    assert jax_filter(JaxFilterConfig(ref_sketches=workload[source],
                                      read_files=[workload["reads"]], **kw), out=want) == 0
    assert filter_run(FilterConfig(ref_sketches=workload[source], read_files=[workload["reads"]],
                                   device="cpu", **kw), out=got) == 0
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("sourmash", [False, True], ids=["rkmh-json", "sig"])
def test_hash_dump_round_trip_equals_stream_from_references(workload, tmp_path, sourmash):
    prefix = str(tmp_path / "panel")
    assert hash_run(HashConfig(read_files=[workload["refs"]], ks=(12,), sketch_size=1000,
                               sourmash_out=sourmash, out_prefix=prefix, device="cpu"),
                    out=io.StringIO()) == 0
    kw = dict(read_files=[workload["reads"]], ks=(12,), sketch_size=1000, device="cpu")
    from_refs, from_sketches = io.StringIO(), io.StringIO()
    stream_run(StreamConfig(ref_files=[workload["refs"]], **kw), out=from_refs)
    stream_run(StreamConfig(ref_sketches=prefix + (".sig" if sourmash else ".rkmh.json"), **kw),
               out=from_sketches)
    assert from_sketches.getvalue() == from_refs.getvalue()


@pytest.mark.parametrize("command", ["stream", "filter"])
@pytest.mark.parametrize("flags", [["-R", "{dump}"], ["-R", "{fixture}", "--ref-sketches", "{dump}"]],
                         ids=["R", "R-and-ref-sketches"])
def test_cli_R_is_an_alias_of_ref_sketches_as_in_jax(workload, capsys, command, flags):
    flags = [f.format(dump=workload["torch_dump"], fixture=workload["fixture"]) for f in flags]
    argv = [command, "-f", workload["reads"], "-k", "12", "-s", "300", *flags]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.out
    warnings = [ln for ln in want.err.splitlines() if ln.startswith("warning")]
    assert [ln for ln in got.err.splitlines() if ln.startswith("warning")] == warnings
    assert len(warnings) == (len(flags) > 2)
