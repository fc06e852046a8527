"""The command drivers with ``--devices N [--tp T]`` against rkmh-tpu's.

rkmh-tpu runs each command over the 8 virtual CPU devices tests/conftest.py
gives JAX; the port over ``mesh_devices = (cpu,) * 8`` (its drivers' seam
for the devices a grid takes), where every kernel is its plain version.
Both read the same synthetic files (``rkmh_tpu_torch.synth``, seeded: 8
references of 2 kb, 240 reads of 150 bp).  stdout and the files written
(``-o``, filter's ``.progress``, count's npz) must be byte-identical:

* stream at (dp, tp) = (4, 1), (2, 2) and (1, 4), with -M, -i and --resume;
* filter at (2, 2), with -M, and -o with its ``.progress`` sidecar;
* hash (-s too), count and search with --devices 4;
* every geometry reason logs rkmh-tpu's line, word for word, and the
  command runs on one device with rkmh-tpu's output: --devices not
  divisible by --tp, more devices than the visible ones, a -M counter size
  the dp shards do not divide, --tp not dividing the references.
"""

import io

import numpy as np
import pytest
import torch

from rkmh_tpu.commands import count_cmd as jax_count
from rkmh_tpu.commands import filter_cmd as jax_filter
from rkmh_tpu.commands import hash_cmd as jax_hash
from rkmh_tpu.commands import search_cmd as jax_search
from rkmh_tpu.commands import stream as jax_stream
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands import count_cmd, filter_cmd, hash_cmd, search_cmd, stream

GRID = (torch.device("cpu"),) * 8  # as many entries as JAX's virtual devices


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    refs, reads, _, _ = synth.write_workload(str(d), 240, num_refs=8, genome_len=2000, seed=3)
    seq = "".join(open(refs).read().split(">")[1].split("\n")[1:])
    kmers = str(d / "kmers.txt")
    with open(kmers, "w") as fh:
        fh.write("\n".join(seq[i: i + 12] for i in range(0, 1800, 7)) + "\n")
    return {"dir": d, "refs": refs, "reads": reads, "kmers": kmers}


def _stream(work, stdin=None, out_file="", **kw):
    """(rkmh-tpu's stdout, the port's) of one stream configuration."""
    files = [] if kw.get("in_stream") else [work["reads"]]
    src = (lambda: open(work["reads"], "rb")) if kw.get("in_stream") else (lambda: None)
    want, got = io.StringIO(), io.StringIO()
    jax_out = out_file + ".jax" if out_file else ""
    assert jax_stream.run(jax_stream.StreamConfig(
        ref_files=[work["refs"]], read_files=files, batch_size=64, out_file=jax_out, **kw),
        out=None if out_file else want, stdin=src()) == 0
    assert stream.run(stream.StreamConfig(
        ref_files=[work["refs"]], read_files=files, batch_size=64, device="cpu",
        mesh_devices=GRID, out_file=out_file, **kw),
        out=None if out_file else got, stdin=src()) == 0
    return want.getvalue(), got.getvalue()


@pytest.mark.parametrize("tp", [1, 2, 4], ids=["dp4-tp1", "dp2-tp2", "dp1-tp4"])
def test_stream_devices_byte_identical(work, tp, capsys):
    want, got = _stream(work, ks=(12,), sketch_size=1000, devices=4, tp=tp, min_matches=20,
                        min_diff=1)
    assert len(want.splitlines()) == 240 and got == want
    assert "ignored" not in capsys.readouterr().err


@pytest.mark.parametrize("tp", [1, 2, 4], ids=["dp4-tp1", "dp2-tp2", "dp1-tp4"])
def test_stream_devices_M_I_byte_identical(work, tp):
    kw = dict(ks=(12,), sketch_size=1000, devices=4, tp=tp, min_kmer_occ=2, max_samples=3,
              counter_size=65536)
    want, got = _stream(work, **kw)
    assert got == want
    plain = _stream(work, ks=(12,), sketch_size=1000, devices=4, tp=tp)[1]
    assert got != plain  # the counters changed some lines


def test_stream_devices_stdin_byte_identical(work):
    want, got = _stream(work, ks=(12,), sketch_size=1000, devices=4, tp=2, in_stream=True)
    assert len(want.splitlines()) == 240 and got == want


def test_stream_devices_resume_byte_identical(work, tmp_path):
    out = str(tmp_path / "out.tsv")
    kw = dict(ks=(12,), sketch_size=1000, devices=4, tp=2, min_kmer_occ=2, counter_size=65536)
    _stream(work, out_file=out, **kw)
    full = open(out + ".jax").read()
    assert open(out).read() == full
    with open(out, "w") as fh:  # an interrupted run: 100 lines and a torn one
        fh.write("".join(full.splitlines(keepends=True)[:100]) + full.splitlines()[100][:7])
    assert stream.run(stream.StreamConfig(
        ref_files=[work["refs"]], read_files=[work["reads"]], batch_size=64, device="cpu",
        mesh_devices=GRID, out_file=out, resume=True, **kw)) == 0
    assert open(out).read() == full


def _filter(work, out_file="", **kw):
    want, got = io.StringIO(), io.StringIO()
    assert jax_filter.run(jax_filter.FilterConfig(
        ref_files=[work["refs"]], read_files=[work["reads"]], batch_size=64,
        out_file=out_file + ".jax" if out_file else "", **kw),
        out=None if out_file else want) == 0
    assert filter_cmd.run(filter_cmd.FilterConfig(
        ref_files=[work["refs"]], read_files=[work["reads"]], batch_size=64, device="cpu",
        mesh_devices=GRID, out_file=out_file, **kw), out=None if out_file else got) == 0
    return want.getvalue(), got.getvalue()


@pytest.mark.parametrize("kw", [dict(), dict(min_kmer_occ=2, max_samples=3, counter_size=65536)],
                         ids=["plain", "M-I"])
def test_filter_devices_byte_identical(work, kw):
    want, got = _filter(work, ks=(12,), min_matches=60, devices=4, tp=2, **kw)
    assert 0 < want.count("\n") < 4 * 240 and got == want


def test_filter_devices_output_and_progress_byte_identical(work, tmp_path):
    out = str(tmp_path / "kept.fq")
    _filter(work, out_file=out, ks=(12,), min_matches=60, min_kmer_occ=2, counter_size=65536,
            devices=4, tp=2, chunk_reads=50)
    for suffix in ("", ".progress"):
        with open(out + suffix, "rb") as a, open(out + ".jax" + suffix, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("kw", [dict(), dict(sketch_size=100)], ids=["hashes", "s100"])
def test_hash_devices_byte_identical(work, kw, capsys):
    want, got = io.StringIO(), io.StringIO()
    assert jax_hash.run(jax_hash.HashConfig(read_files=[work["reads"]], ks=(12,), devices=4,
                                            batch_size=50, **kw), out=want) == 0
    assert hash_cmd.run(hash_cmd.HashConfig(read_files=[work["reads"]], ks=(12,), devices=4,
                                            batch_size=50, device="cpu", mesh_devices=GRID,
                                            **kw), out=got) == 0
    assert len(want.getvalue().splitlines()) == 240 and got.getvalue() == want.getvalue()
    assert "ignored" not in capsys.readouterr().err


def test_count_devices_byte_identical(work, tmp_path):
    want, got = io.StringIO(), io.StringIO()
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jax_count.run(jax_count.CountConfig(read_files=[work["reads"]], ks=(12,), devices=4,
                                               batch_size=50, out_file=a, dump=True),
                         out=want) == 0
    assert count_cmd.run(count_cmd.CountConfig(read_files=[work["reads"]], ks=(12,), devices=4,
                                               batch_size=50, out_file=b, dump=True, device="cpu",
                                               mesh_devices=GRID), out=got) == 0
    assert want.getvalue() and got.getvalue() == want.getvalue()
    with np.load(a) as x, np.load(b) as y:
        assert all(np.array_equal(x[k], y[k]) for k in x.files)


def test_search_devices_byte_identical(work):
    want, got = io.StringIO(), io.StringIO()
    assert jax_search.run(jax_search.SearchConfig(ref_files=[work["kmers"]],
                                                  read_files=[work["reads"]], ks=(12,),
                                                  devices=4, batch_size=50), out=want) == 0
    assert search_cmd.run(search_cmd.SearchConfig(ref_files=[work["kmers"]],
                                                  read_files=[work["reads"]], ks=(12,),
                                                  devices=4, batch_size=50, device="cpu",
                                                  mesh_devices=GRID), out=got) == 0
    assert "," in want.getvalue() and got.getvalue() == want.getvalue()


@pytest.mark.parametrize("command,kw,reason", [
    ("stream", dict(devices=4, tp=3), "--devices 4 is not divisible by --tp 3"),
    ("stream", dict(devices=16), "--devices 16 > 8 visible device(s)"),
    ("stream", dict(devices=4, tp=2, min_kmer_occ=2, counter_size=65537),
     "-M counter size 65537 is not divisible by the 2 dp shards"),
    ("stream", dict(devices=3, tp=3), "--tp 3 does not divide 8 references"),
    ("filter", dict(devices=6, tp=4), "--devices 6 is not divisible by --tp 4"),
    ("filter", dict(devices=4, tp=4, min_kmer_occ=2, counter_size=65537), None),
    ("filter", dict(devices=6, tp=3), "--tp 3 does not divide 8 references"),
    ("filter", dict(devices=2, tp=1, min_kmer_occ=2, counter_size=65537),
     "-M counter size 65537 is not divisible by the 2 dp shards"),
], ids=["stream-tp", "stream-visible", "stream-counter", "stream-refs", "filter-tp",
        "filter-dp1-counter", "filter-refs", "filter-counter"])
def test_geometry_reasons_log_the_reference_line(work, command, kw, reason, capsys):
    """A geometry that cannot apply logs rkmh-tpu's line and runs on one
    device with rkmh-tpu's output; one that can (dp 1 divides any counter)
    logs nothing."""
    run = _stream if command == "stream" else _filter
    want, got = run(work, ks=(12,), **kw)
    err = capsys.readouterr().err.splitlines()
    line = f"{command} --devices ignored ({reason}); running single-device"
    if reason is None:
        assert not [ln for ln in err if "ignored" in ln]
    else:
        assert err.count(line) == 2  # rkmh-tpu's, then the port's
    assert got == want


@pytest.mark.parametrize("command", ["hash", "count", "search"])
def test_dp_commands_log_the_reference_line(work, command, tmp_path, capsys):
    line = "--devices ignored (--devices 16 > 8 visible device(s)); running single-device"
    want, got = io.StringIO(), io.StringIO()
    if command == "hash":
        jax_hash.run(jax_hash.HashConfig(read_files=[work["reads"]], ks=(12,), devices=16),
                     out=want)
        hash_cmd.run(hash_cmd.HashConfig(read_files=[work["reads"]], ks=(12,), devices=16,
                                         device="cpu", mesh_devices=GRID), out=got)
    elif command == "count":
        jax_count.run(jax_count.CountConfig(read_files=[work["reads"]], ks=(12,), devices=16,
                                            dump=True), out=want)
        count_cmd.run(count_cmd.CountConfig(read_files=[work["reads"]], ks=(12,), devices=16,
                                            dump=True, device="cpu", mesh_devices=GRID), out=got)
    else:
        jax_search.run(jax_search.SearchConfig(ref_files=[work["kmers"]],
                                               read_files=[work["reads"]], ks=(12,), devices=16),
                       out=want)
        search_cmd.run(search_cmd.SearchConfig(ref_files=[work["kmers"]],
                                               read_files=[work["reads"]], ks=(12,), devices=16,
                                               device="cpu", mesh_devices=GRID), out=got)
    assert capsys.readouterr().err.splitlines().count(line) == 2
    assert got.getvalue() and got.getvalue() == want.getvalue()


def test_cli_devices_on_the_cpu_sees_one_device(work, capsys):
    """``--devices 2 --device cpu`` through the CLI: the CPU is one device,
    so the port logs rkmh-tpu's fallback line and prints one device's
    bytes."""
    from rkmh_tpu_torch import cli

    argv = ["stream", "-r", work["refs"], "-f", work["reads"], "-k", "12"]
    want = io.StringIO()
    jax_stream.run(jax_stream.StreamConfig(ref_files=[work["refs"]], read_files=[work["reads"]],
                                           ks=(12,)), out=want)
    assert cli.main([*argv, "--devices", "2", "--tp", "1", "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.getvalue()
    assert ("stream --devices ignored (--devices 2 > 1 visible device(s)); running "
            "single-device") in got.err.splitlines()
