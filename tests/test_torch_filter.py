"""`rkmh-tpu-torch filter` output byte-identical to `rkmh-tpu filter`.

Both packages filter the same synthetic files (rkmh_tpu_torch.synth, made
from a seed): a 6-ref x 2 kb panel, 150 bp FASTQ reads with N bases, 700
bp reads, and a FASTA file of mixed lengths (empty and shorter than k
included) holding reads that match nothing.  Cases: file mode with
-N/-D/-M/-I (small counters that force collisions, a decimal prime and a
power of two), -i mode with and without -M (with -M and no -f the counter
stays empty and every read fails), -f plus -i, the CLI with its dead
parity flags, the flags that stay rejected, and the ``-o FILE.progress``
sidecar (each save and the final file) at two chunk sizes.  The port runs
its plain path on the CPU.  Tolerance: none; outputs are text and must be
equal.
"""

import gzip
import io
import os
import sys

import numpy as np
import pytest

from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands import recovery as jax_recovery
from rkmh_tpu.commands.filter_cmd import FilterConfig as JaxConfig
from rkmh_tpu.commands.filter_cmd import run as jax_run
from rkmh_tpu_torch import cli, synth
from rkmh_tpu_torch.commands import recovery
from rkmh_tpu_torch.commands.filter_cmd import FilterConfig, run


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("filter")
    refs, short, _, _ = synth.write_workload(str(d / "short"), 160, 150, num_refs=6,
                                             genome_len=2000, seed=7, n_rate=0.02)
    _, genomes = synth.make_panel(6, 2000, seed=7)
    long_reads, _ = synth.make_reads(genomes, 30, 700, seed=9)
    long = str(d / "long.fq")
    synth.write_fastq(long, long_reads)
    mixed_reads, _ = synth.make_reads(genomes, 80, 700, n_rate=0.01, seed=10)
    lens = np.random.default_rng(11).integers(0, 700, 80)
    lens[:3] = (0, 5, 11)
    strangers = synth.make_reads(synth.make_panel(1, 2000, seed=99)[1], 4, 300, seed=12)[0]
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(mixed_reads, lens)):
            fh.write(f">m{i} some description\n{r[:n].tobytes().decode()}\n")
        for i, r in enumerate(strangers):  # reads from a genome outside the panel
            fh.write(f">stranger{i}\n{r.tobytes().decode()}\n")
    with open(short, "rb") as src, gzip.open(str(d / "short.fq.gz"), "wb") as dst:
        dst.write(src.read())
    return {"refs": refs, "short": short, "long": long, "mixed": mixed,
            "short_gz": str(d / "short.fq.gz")}


def _n_reads(path) -> int:
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as fh:
        return sum(1 for ln in fh if ln[0] in "@>")


def _both(workload, reads, stdin=None, **kw):
    files = [workload[r] for r in reads]
    want, got = io.StringIO(), io.StringIO()
    jkw = {k: v for k, v in kw.items() if k != "device"}
    src = (lambda: open(workload[stdin], "rb")) if stdin else (lambda: None)
    assert jax_run(JaxConfig(ref_files=[workload["refs"]], read_files=files, **jkw),
                   out=want, stdin=src()) == 0
    stats = {}
    assert run(FilterConfig(ref_files=[workload["refs"]], read_files=files, device="cpu",
                            **kw), out=got, stdin=src(), stats=stats) == 0
    return want.getvalue(), got.getvalue(), stats


@pytest.mark.parametrize("reads,kw", [
    (["short"], dict(ks=(12,))),
    (["short"], dict(ks=(12,), min_matches=45, min_diff=2)),
    (["short", "mixed"], dict(ks=(12,), min_kmer_occ=2, max_samples=3, counter_size=65521,
                              min_matches=45)),
    (["mixed"], dict(ks=(12,), sketch_size=200, min_kmer_occ=3, min_matches=20,
                     counter_size=16384, batch_size=16, chunk_reads=50)),
    (["long"], dict(ks=(12, 16), sketch_size=50, max_samples=4, counter_size=4096,
                    min_diff=10)),
    (["short_gz", "mixed"], dict(ks=(12,), min_kmer_occ=2, counter_size=65521, min_matches=45,
                                 chunk_reads=64)),
], ids=["default", "N-D", "M-I-prime", "mixed-lengths-M-pow2", "long-s50-I",
        "gzip-two-files-M"])
def test_filter_output_byte_identical_to_jax(workload, reads, kw):
    want, got, stats = _both(workload, reads, **kw)
    n_reads = sum(_n_reads(workload[r]) for r in reads)
    records = want.split("\n")[:-1]
    kept = len(records) // 4
    assert len(records) % 4 == 0 and 0 < kept <= n_reads
    if kw.get("min_matches", -1) > 0 or kw.get("min_diff") or "mixed" in reads:
        assert kept < n_reads
    assert got == want
    assert stats == {"reads": n_reads, "kept": kept}
    counted = {"min_kmer_occ", "max_samples", "counter_size"}
    if counted & set(kw):  # the counters changed what is kept
        plain = {k: v for k, v in kw.items() if k not in counted}
        plain_out = io.StringIO()
        run(FilterConfig(ref_files=[workload["refs"]], read_files=[workload[r] for r in reads],
                         device="cpu", **plain), out=plain_out)
        assert plain_out.getvalue() != got
    if "mixed" in reads:
        assert "\n+\nIII" in want  # FASTA reads get I qualities
        assert ">stranger" not in want  # reads that match nothing fail the diff filter


@pytest.mark.parametrize("reads,kw", [
    ([], dict(ks=(12,), min_matches=10)),
    ([], dict(ks=(12,), min_kmer_occ=2, counter_size=1009)),
    (["short"], dict(ks=(12,), min_kmer_occ=2, max_samples=3, counter_size=16384,
                     batch_size=64)),
], ids=["i", "i-M-empty-counter", "f-and-i-M-I"])
def test_filter_stream_mode_byte_identical_to_jax(workload, reads, kw):
    want, got, _ = _both(workload, reads, stdin="mixed", in_stream=True, **kw)
    lines = want.splitlines()
    assert sum(ln.startswith("Sample: ") for ln in lines) == 84
    assert got == want
    assert "Sample: m0\tResult: \t0\t0\tFAIL:DEPTH" in want  # the empty read
    if kw.get("min_kmer_occ", -1) >= 0 and not reads:
        # no -f: the counter saw no read, so every streamed read has no hash
        assert all("FAIL:DEPTH" in ln for ln in lines)
    if reads:
        assert want.startswith(">")  # the -f records come first


@pytest.mark.parametrize("chunk_reads", [37, 0])  # chunks of 37 reads, and one chunk
@pytest.mark.parametrize("reads,in_stream,kw", [
    (["short", "mixed"], False, dict(ks=(12,), min_matches=45)),
    (["mixed"], False, dict(ks=(12,), min_kmer_occ=2, counter_size=16384, batch_size=16)),
    (["short"], True, dict(ks=(12,), min_matches=10)),
    ([], True, dict(ks=(12,))),
    (["short_gz", "mixed"], False, dict(ks=(12,), min_matches=45)),
], ids=["files", "files-M", "f-and-i", "i", "gzip-files"])
def test_filter_progress_sidecar_byte_identical_to_jax(workload, tmp_path, monkeypatch,
                                                      reads, in_stream, kw, chunk_reads):
    """``filter -o FILE`` writes FILE and FILE.progress as rkmh-tpu does:
    a save after each file-mode chunk (reads done, bytes flushed), none for
    the -i stream."""
    saves = {"jax": [], "port": []}
    for name, cls in (("jax", jax_recovery.Progress), ("port", recovery.Progress)):
        def save(self, reads_done, output_bytes, _orig=cls.save, _log=saves[name]):
            assert os.path.getsize(self.path[: -len(".progress")]) == output_bytes  # flushed
            _log.append((reads_done, output_bytes))
            _orig(self, reads_done, output_bytes)
        monkeypatch.setattr(cls, "save", save)
    files = [workload[r] for r in reads]
    outs = {}
    for name in ("jax", "port"):
        out = str(tmp_path / f"{name}.out")
        stdin = open(workload["mixed"], "rb") if in_stream else None
        cfg = dict(ref_files=[workload["refs"]], read_files=files, in_stream=in_stream,
                   chunk_reads=chunk_reads, out_file=out, **kw)
        if name == "jax":
            assert jax_run(JaxConfig(**cfg), stdin=stdin) == 0
        else:
            assert run(FilterConfig(device="cpu", **cfg), stdin=stdin) == 0
        if stdin is not None:
            stdin.close()
        outs[name] = [open(p, "rb").read() if os.path.exists(p) else None
                      for p in (out, out + ".progress")]
    assert outs["port"] == outs["jax"]
    assert saves["port"] == saves["jax"]
    per_file = [_n_reads(workload[r]) for r in reads]
    if not reads:  # -i alone: no file-mode chunk, so no sidecar
        assert outs["port"][1] is None and saves["port"] == []
    else:  # a save per chunk; chunks never span files
        assert len(saves["port"]) == sum(-(-n // (chunk_reads or 65536)) for n in per_file)
        assert saves["port"][-1][0] == sum(per_file)
        assert outs["port"][1] == b'{"reads": %d, "bytes": %d}' % saves["port"][-1]
        assert saves["port"][-1][1] <= len(outs["port"][0])  # -i lines come after it


def test_filter_stream_parse_error_is_raised(workload):
    with pytest.raises(ValueError, match="unrecognized"):
        run(FilterConfig(ref_files=[workload["refs"]], in_stream=True, ks=(12,),
                         device="cpu"), out=io.StringIO(), stdin=io.BytesIO(b"garbage\n"))


def test_cli_filter_matches_jax(workload, tmp_path, capsys, monkeypatch):
    argv = ["filter", "-r", workload["refs"], "-f", workload["short"], "-k", "12",
            "-M", "2", "-N", "5", "-I", "3", "--counter-size", "2048",
            "-S", "7", "-F", "pre.fq", "-p", "r.map", "-q", "q.map", "-d"]
    out = str(tmp_path / "out.fq")
    assert jax_main([*argv, "-o", out + ".jax"]) == 0
    want_err = [ln for ln in capsys.readouterr().err.splitlines() if "warning" in ln]
    assert cli.main([*argv, "--device", "cpu", "-o", out]) == 0
    got_err = [ln for ln in capsys.readouterr().err.splitlines() if "warning" in ln]
    assert len(want_err) == 3 and got_err == want_err
    with open(out) as a, open(out + ".jax") as b:
        assert a.read() == b.read()
    # -i reads the process's stdin
    with open(workload["mixed"], "rb") as fh:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(fh.read())))
    assert cli.main(["filter", "-r", workload["refs"], "-i", "-k", "12", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    want, _, _ = _both(workload, [], stdin="mixed", in_stream=True, ks=(12,))
    assert got == want


@pytest.mark.parametrize("flag", [["--devices", "4"], ["--tp", "4"], ["--dist-procs", "4"],
                                  ["--devices", "2"], ["--tp", "2"],
                                  ["--dist-coordinator", "h:1"], ["--dist-procs", "2"],
                                  ["--dist-rank", "0"]])
def test_cli_filter_rejects_flags_not_yet_ported(flag, workload, capsys):
    """Every flag here runs since it was ported, as rkmh-tpu runs it.
    ``--devices N --device cpu`` sees one device, logs rkmh-tpu's fallback
    line and prints rkmh-tpu's bytes; ``--tp N`` alone and ``--dist-rank 0``
    alone run in one process and log nothing.  ``--dist-coordinator`` and
    ``--dist-procs N`` take the multi-process drain, which refuses (before
    any process group) ``-i``, ``--resume`` without ``-o`` and stdin as a
    ``-f`` file with rkmh-tpu's lines and exit code."""
    argv = ["filter", "-r", workload["refs"], "-f", workload["short"], "-k", "12", "-N",
            "45", *flag]
    if flag[0] in ("--dist-coordinator", "--dist-procs"):
        argv += {"--dist-coordinator": ["--resume"], "4": ["-i"], "2": ["-f", "-"]}[
            flag[0] if flag[0] == "--dist-coordinator" else flag[1]]
        assert jax_main(argv) == 1
        want = capsys.readouterr()
        assert cli.main([*argv, "--device", "cpu"]) == 1
        got = capsys.readouterr()
        assert got.out == want.out == "" and got.err == want.err
        assert got.err.startswith("filter --dist-* ") and got.err.count("\n") == 1
        return
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want and 0 < want.count("\n") < 4 * 160
    fallback = (f"filter --devices ignored (--devices {flag[1]} > 1 visible device(s)); "
                "running single-device")
    assert [ln for ln in got.err.splitlines() if "ignored" in ln or "dist" in ln] == (
        [fallback] if flag[0] == "--devices" else [])


@pytest.mark.parametrize("flag", ["-z", "-m"])
def test_cli_filter_has_no_stream_only_flags(flag, capsys):
    for main in (jax_main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["filter", "-r", "refs.fa", "-f", "reads.fq", flag])
        assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
