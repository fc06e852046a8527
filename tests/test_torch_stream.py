"""`rkmh-tpu-torch stream` output byte-identical to `rkmh-tpu stream`.

Both packages classify the same synthetic files (rkmh_tpu_torch.synth,
made from a seed): zika-shaped short reads at k=12 s=1000 (W <= s),
long reads at s=50 (W > s), -k 12 -k 16, -N/-D thresholds, and reads of
mixed lengths (empty and shorter than k included) split over several
chunks and batches.  The port runs its plain path on the CPU.  Also: the
CLI surface, and that the port never imports JAX.
"""

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
    return {"refs": refs, "short": short, "long": long, "mixed": mixed}


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
], ids=["k12-s1000", "long-s50", "k12-k16", "N-D", "mixed-lengths"])
def test_stream_output_byte_identical_to_jax(workload, reads, kw):
    want, got = _both(workload, reads, **kw)
    n_reads = sum(1 for r in reads for _ in open(workload[r]) if _[0] in "@>")
    assert len(want.splitlines()) == n_reads
    assert got == want


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


@pytest.mark.parametrize("flag", [["-M", "2"], ["-I", "3"], ["-i"], ["--devices", "2"],
                                  ["--resume"], ["--ref-sketches", "x.json"]])
def test_cli_rejects_flags_not_yet_ported(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["stream", "-r", "refs.fa", "-f", "reads.fq", *flag])
    assert exc.value.code == 2
    assert f"{flag[0]} not yet ported" in capsys.readouterr().err


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
