"""``--metrics``, ``RKMH_TPU_METRICS`` and ``RKMH_TPU_PROFILE`` in the port
against rkmh-tpu's.

For every subcommand the JSON line the port writes to stderr at exit must
carry rkmh-tpu's keys and the same ``reads`` and ``bp`` integers on the
same input (times are not compared); ``RKMH_TPU_METRICS=1`` must do what
the flag does, nothing must be written when neither is given, the
counters must start from zero in each run, and ``RKMH_TPU_PROFILE=<dir>``
must write a profiler trace on the CPU.  Inputs are synthetic
(rkmh_tpu_torch.synth, made from a seed); the port runs its plain path on
the CPU.
"""

import json
import os

import pytest

from rkmh_tpu.cli import main as jax_main
from rkmh_tpu_torch import cli, observability, synth


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("metrics")
    refs, reads, _, _ = synth.write_workload(str(d), 40, 150, num_refs=4, genome_len=1200,
                                             seed=3, n_rate=0.01)
    _, genomes = synth.make_panel(4, 1200, seed=3)
    kmers = str(d / "kmers.txt")
    with open(kmers, "w") as fh:
        g = synth._ACGTN[genomes]
        fh.writelines(g[0, p: p + 12].tobytes().decode() + "\n" for p in range(0, 1100, 11))
    hp = synth.write_hpv16_refpath(str(d / "hpv16"), seed=3, num_types=6, genome_len=1200)
    hp_reads, _ = synth.make_nanopore_reads(12, 5, hp, mean_len=800, min_len=800, max_len=800)
    synth.write_fastq_records(str(d / "hpv16.fq"), hp_reads)
    ref, call_reads, _, _ = synth.write_call_workload(str(d / "call"), n_reads=60, seed=5)
    return {"refs": refs, "reads": reads, "kmers": kmers, "hpv16": str(d / "hpv16"),
            "hpv16_reads": str(d / "hpv16.fq"), "ref": ref, "call_reads": call_reads}


def _argv(command, data):
    r, f = data["refs"], data["reads"]
    return {
        "stream": ["stream", "-r", r, "-f", f, "-k", "12", "--batch-size", "16"],
        "classify": ["classify", "-r", r, "-f", f, "-k", "12"],
        "stream -M": ["stream", "-r", r, "-f", f, "-k", "12", "-M", "2",
                      "--counter-size", "4099"],
        "filter": ["filter", "-r", r, "-f", f, "-k", "12", "-N", "5"],
        "hpv16": ["hpv16", "-f", data["hpv16_reads"], "-R", data["hpv16"], "-k", "16",
                  "--batch-size", "8"],
        "hash": ["hash", "-f", f, "-k", "12", "--batch-size", "16"],
        "count": ["count", "-f", f, "-k", "12"],
        "search": ["search", "-r", data["kmers"], "-f", f, "-k", "12"],
        "call": ["call", "-r", data["ref"], "-f", data["call_reads"], "-k", "16"],
    }[command]


def _metrics(err: str):
    lines = [ln for ln in err.splitlines() if ln.startswith("{")]
    return [json.loads(ln) for ln in lines]


def _run_both(argv, capsys):
    capsys.readouterr()
    assert jax_main(argv) == 0
    want = _metrics(capsys.readouterr().err)
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return want, _metrics(capsys.readouterr().err)


@pytest.mark.parametrize("command", ["stream", "classify", "stream -M", "filter", "hpv16",
                                     "hash", "count", "search", "call"])
def test_metrics_line_matches_jax(data, tmp_path, monkeypatch, capsys, command):
    monkeypatch.chdir(tmp_path)  # hpv16's .tst side file
    monkeypatch.delenv("RKMH_TPU_METRICS", raising=False)
    want, got = _run_both([*_argv(command, data), "--metrics"], capsys)
    assert len(want) == len(got) == 1
    (want,), (got,) = want, got
    assert sorted(got) == sorted(want)
    assert got["command"] == want["command"] == command.split()[0]
    assert (got["reads"], got["bp"]) == (want["reads"], want["bp"])
    assert got["reads"] > 0 and got["bp"] > got["reads"]


def test_metrics_env_and_silence(data, monkeypatch, capsys):
    argv = _argv("stream", data)
    monkeypatch.setenv("RKMH_TPU_METRICS", "1")
    want, got = _run_both(argv, capsys)
    assert len(got) == len(want) == 1 and sorted(got[0]) == sorted(want[0])
    assert got[0]["reads"] == want[0]["reads"] == 40
    monkeypatch.setenv("RKMH_TPU_METRICS", "0")
    assert _run_both(argv, capsys) == ([], [])
    monkeypatch.delenv("RKMH_TPU_METRICS")
    assert _run_both(argv, capsys) == ([], [])


def test_counters_reset_between_runs(data, capsys):
    argv = [*_argv("hash", data), "--metrics", "--device", "cpu"]
    observability.count("reads", 1000)  # left over from an earlier run in this process
    lines = []
    for _ in range(2):
        assert cli.main(argv) == 0
        lines += _metrics(capsys.readouterr().err)
    assert [ln["reads"] for ln in lines] == [40, 40]
    assert [ln["bp"] for ln in lines] == [6000, 6000]


def test_profile_hook_writes_a_trace_on_the_cpu(data, tmp_path, monkeypatch, capsys):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("RKMH_TPU_PROFILE", str(trace_dir))
    assert cli.main([*_argv("stream", data), "--metrics", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert f"rkmh-tpu-torch: device trace written to {trace_dir}" in err
    with open(trace_dir / observability.TRACE_FILE) as fh:
        trace = json.load(fh)
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("sort" in n or "searchsorted" in n or "gather" in n for n in names)
    assert len(_metrics(err)) == 1
    assert os.listdir(trace_dir) == [observability.TRACE_FILE]
