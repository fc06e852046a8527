"""`rkmh-tpu-torch stream` output byte-identical to `rkmh-tpu stream`.

Both packages classify the same synthetic files (rkmh_tpu_torch.synth,
made from a seed): zika-shaped short reads at k=12 s=1000 (W <= s),
long reads at s=50 (W > s), -k 12 -k 16, -N/-D thresholds, and reads of
mixed lengths (empty and shorter than k included) split over several
chunks and batches; -M, -I and both, on small counters that force
collisions (a decimal prime and a power of two), reads with N bases.  The
port runs its plain path on the CPU.  Also: the CLI surface (rkmh's dead
parity flags accepted with rkmh-tpu's warnings; ``-f ... -i`` logs that -i
is ignored and classifies the files, as rkmh-tpu does, and ``-i`` alone
classifies stdin; the stdin path itself is in test_torch_stream_stdin.py),
and that the port never imports JAX.
"""

import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rkmh_tpu.commands.stream import StreamConfig as JaxConfig
from rkmh_tpu.commands.stream import run as jax_run
from rkmh_tpu_torch import cli, synth
from rkmh_tpu_torch.commands.stream import StreamConfig, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A 6-ref x 2 kb panel with 150 bp, 700 bp and mixed-length reads."""
    d = tmp_path_factory.mktemp("synth")
    refs, short, names, _ = synth.write_workload(str(d / "short"), 200, 150,
                                                 num_refs=6, genome_len=2000, seed=7)
    _, genomes = synth.make_panel(6, 2000, seed=7)
    long_reads, _ = synth.make_reads(genomes, 40, 700, seed=9)
    long = str(d / "long.fq")
    synth.write_fastq(long, long_reads)
    # mixed lengths: cut reads to random lengths, a few empty or < k
    mixed_reads, _ = synth.make_reads(genomes, 120, 700, seed=10)
    lens = np.random.default_rng(11).integers(0, 700, 120)
    lens[:3] = (0, 5, 11)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(mixed_reads, lens)):
            fh.write(f">m{i} some description\n{r[:n].tobytes().decode()}\n")
    with open(short, "rb") as src, gzip.open(str(d / "short.fq.gz"), "wb") as dst:
        dst.write(src.read())
    return {"refs": refs, "short": short, "long": long, "mixed": mixed,
            "short_gz": str(d / "short.fq.gz")}


def _n_reads(path) -> int:
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as fh:
        return sum(1 for ln in fh if ln[0] in "@>")


def _both(workload, reads, **kw):
    files = [workload[r] for r in reads]
    want = io.StringIO()
    assert jax_run(JaxConfig(ref_files=[workload["refs"]], read_files=files, **kw),
                   out=want) == 0
    port_kw = {k: v for k, v in kw.items() if k not in ("batch_size", "chunk_reads")}
    got = io.StringIO()
    assert run(StreamConfig(ref_files=[workload["refs"]], read_files=files,
                            device="cpu", batch_size=kw.get("batch_size", 0),
                            chunk_reads=kw.get("chunk_reads", 0), **port_kw),
               out=got) == 0
    return want.getvalue(), got.getvalue()


@pytest.mark.parametrize("reads,kw", [
    (["short"], dict(ks=(12,), sketch_size=1000)),
    (["long"], dict(ks=(12,), sketch_size=50)),
    (["short"], dict(ks=(12, 16), sketch_size=1000)),
    (["short", "long"], dict(ks=(12,), sketch_size=1000, min_matches=12, min_diff=3)),
    (["mixed"], dict(ks=(12,), sketch_size=200, batch_size=16, chunk_reads=50)),
    (["short"], dict(ks=(12,), sketch_size=1000, min_kmer_occ=2, counter_size=65521)),
    (["short", "long"], dict(ks=(12,), sketch_size=1000, max_samples=3, counter_size=4096)),
    (["mixed", "short"], dict(ks=(12, 16), sketch_size=50, min_kmer_occ=2, max_samples=4,
                              counter_size=16384, batch_size=16, chunk_reads=50)),
    (["short_gz", "mixed"], dict(ks=(12,), sketch_size=1000, min_kmer_occ=2,
                                 counter_size=65521, chunk_reads=64)),
], ids=["k12-s1000", "long-s50", "k12-k16", "N-D", "mixed-lengths", "M", "I", "M-I",
        "gzip-two-files-M"])
def test_stream_output_byte_identical_to_jax(workload, reads, kw):
    want, got = _both(workload, reads, **kw)
    n_reads = sum(_n_reads(workload[r]) for r in reads)
    assert len(want.splitlines()) == n_reads
    assert got == want
    counted = {"min_kmer_occ", "max_samples", "counter_size"}
    if counted & set(kw):  # the counters changed some lines
        plain = {k: v for k, v in kw.items() if k not in counted}
        assert _both(workload, reads, **plain)[1] != got


def test_cli_stream_matches_jax(workload, tmp_path, capsys):
    out = str(tmp_path / "out.tsv")
    assert cli.main(["classify", "-r", workload["refs"], "-f", workload["short"],
                     "-k", "12", "-s", "1000", "--device", "cpu", "-o", out]) == 0
    assert "alias of stream" in capsys.readouterr().err
    want = io.StringIO()
    jax_run(JaxConfig(ref_files=[workload["refs"]], read_files=[workload["short"]],
                      ks=(12,), sketch_size=1000), out=want)
    with open(out) as fh:
        assert fh.read() == want.getvalue()


def test_cli_accepts_dead_parity_flags_as_jax_does(workload, tmp_path, capsys):
    """rkmh's parsed-but-dead flags run with rkmh-tpu's warnings, and the
    output is rkmh-tpu's; rkmh-tpu-torch exited 2 on them before."""
    from rkmh_tpu.cli import main as jax_main

    argv = ["stream", "-r", workload["refs"], "-f", workload["short"], "-k", "12",
            "-S", "5", "-z", "-m", "-F", "pre.fq", "-F", "pre2.fq", "-p", "r.map",
            "-q", "q.map", "-d"]
    out = str(tmp_path / "out.tsv")
    assert jax_main([*argv, "-o", out + ".jax"]) == 0
    want_err = [ln for ln in capsys.readouterr().err.splitlines() if "warning" in ln]
    assert cli.main([*argv, "--device", "cpu", "-o", out]) == 0
    got_err = [ln for ln in capsys.readouterr().err.splitlines() if "warning" in ln]
    assert len(want_err) == 5 and got_err == want_err
    with open(out) as a, open(out + ".jax") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--dist-coordinator", "h:1"],
                                  ["--devices", "2"], ["--dist-rank", "0"],
                                  ["--dist-procs", "2"]])
def test_cli_rejects_flags_not_yet_ported(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["stream", "-r", "refs.fa", "-f", "reads.fq", *flag])
    assert exc.value.code == 2
    assert f"{flag[0]} not yet ported" in capsys.readouterr().err


IGNORED_I = ("stream -i ignored: -f inputs were given (rkmh classified the files here too "
             "— its -i is dead); classifying the files")


@pytest.mark.parametrize("command", ["stream", "classify"])
def test_cli_stream_files_with_i_match_jax(workload, capsys, monkeypatch, command):
    """``-f reads -i``: rkmh-tpu logs that -i is ignored and classifies the
    files; so does the port, with the same stdout and exit 0.  ``-i`` alone
    classifies stdin."""
    from rkmh_tpu.cli import main as jax_main

    argv = [command, "-r", workload["refs"], "-f", workload["short"], "-k", "12", "-i"]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and len(got.out.splitlines()) == 200
    assert IGNORED_I in want.err.splitlines() and IGNORED_I in got.err.splitlines()
    with open(workload["short"], "rb") as fh:  # -i alone: the same reads on stdin
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(fh.read())))
    assert cli.main([command, "-r", workload["refs"], "-k", "12", "-i", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == got.out


def test_stream_i_without_files_is_not_ported(workload):
    """Ported since: ``-i`` without ``-f`` classifies the stream it is
    given, as file mode classifies the file."""
    with open(workload["mixed"], "rb") as fh:
        raw = fh.read()
    got = io.StringIO()
    assert run(StreamConfig(ref_files=[workload["refs"]], in_stream=True, ks=(12,),
                            sketch_size=200, batch_size=16, device="cpu"), out=got,
               stdin=io.BytesIO(raw)) == 0
    want = _both(workload, ["mixed"], ks=(12,), sketch_size=200, batch_size=16)[0]
    assert got.getvalue() == want and len(want.splitlines()) == 120


def test_cli_cuda_without_gpu_fails(workload, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["stream", "-r", workload["refs"], "-f", workload["short"], "-k", "12"])


def test_cli_missing_file_exits_1(tmp_path):
    assert cli.main(["stream", "-r", str(tmp_path / "none.fa"), "-f", "x.fq",
                     "--device", "cpu"]) == 1


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import rkmh_tpu_torch.cli, rkmh_tpu_torch.commands.stream\n"
            "import rkmh_tpu_torch.convert, rkmh_tpu_torch.synth, rkmh_tpu_torch.ops.kernels\n"
            "import rkmh_tpu_torch.commands.hpv16_cmd, rkmh_tpu_torch.bench.bench_gather\n"
            "import rkmh_tpu_torch.commands.filter_cmd, rkmh_tpu_torch.ops.counter\n"
            "import rkmh_tpu_torch.io.native, rkmh_tpu_torch.bench.timing\n"
            "import rkmh_tpu_torch.bench.read_ahead_ab, rkmh_tpu_torch.oracle\n"
            "import rkmh_tpu_torch.commands.hash_cmd, rkmh_tpu_torch.commands.count_cmd\n"
            "import rkmh_tpu_torch.commands.search_cmd, rkmh_tpu_torch.commands.recovery\n"
            "import rkmh_tpu_torch.io.sketch_json, rkmh_tpu_torch.call_engine\n"
            "import rkmh_tpu_torch.commands.call_cmd, rkmh_tpu_torch.ops.hashmap\n"
            "import rkmh_tpu_torch.bench.call_inputs, rkmh_tpu_torch.bench.l2_sweep\n"
            "import rkmh_tpu_torch.observability, rkmh_tpu_torch.ops.sorted_probe\n"
            "import rkmh_tpu_torch.bench.wide_inputs, rkmh_tpu_torch.bench.bounds\n"
            "import rkmh_tpu_torch.bench.probe_inputs, rkmh_tpu_torch.ops.probe\n"
            "import rkmh_tpu_torch.ml.wabbit, rkmh_tpu_torch.ml.vw_model\n"
            "import rkmh_tpu_torch.classify.library, rkmh_tpu_torch.ops.sparse_margin\n"
            "import pkgutil, importlib, rkmh_tpu_torch.scripts as s\n"
            "names = [m.name for m in pkgutil.iter_modules(s.__path__)]\n"
            "assert len(names) == 12, names\n"
            "for n in names: importlib.import_module('rkmh_tpu_torch.scripts.' + n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rkmh_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_synth_is_deterministic():
    a = synth.make_reads(synth.make_panel(4, 500, seed=2)[1], 10, 50, seed=3)
    b = synth.make_reads(synth.make_panel(4, 500, seed=2)[1], 10, 50, seed=3)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    names, genomes = synth.make_panel(4, 500, divergence=0.05, seed=2)
    div = (genomes[1:] != genomes[0]).mean()
    assert 0.05 < div < 0.15  # two independent ~5% mutants differ by ~10%
