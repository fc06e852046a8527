"""`rkmh-tpu-torch stream -i` (and `classify -i`): reads from stdin,
byte-identical to `rkmh-tpu stream -i` and to the port's file mode.

Inputs are synthetic (``rkmh_tpu_torch.synth``, from a seed): a 6-ref x
2 kb panel, 150 bp reads and reads of mixed lengths (empty and shorter
than k included), given as a ``BytesIO`` or as the process's stdin.  The
port runs its plain path on the CPU at batch size 8, so a stream spans many
batches.  Also: -i with -M (the stream buffered, two passes), empty stdin,
a malformed record (raised, after the lines of the whole batches before
it), -i with --resume
(exit 1), at most 3 batches of lines held back, and a source that stalls
without EOF: its lines must come out before more input does (a thread
timeout turns a deadlock into a failure, not a hang).
"""

import io
import sys
import threading

import numpy as np
import pytest

from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.stream import StreamConfig as JaxConfig
from rkmh_tpu.commands.stream import run as jax_run
from rkmh_tpu_torch import cli, synth
from rkmh_tpu_torch.commands import stream
from rkmh_tpu_torch.commands.stream import StreamConfig, run

BATCH = 8


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("stdin")
    refs, short, _, _ = synth.write_workload(str(d / "w"), 60, 150, num_refs=6,
                                             genome_len=2000, seed=13)
    _, genomes = synth.make_panel(6, 2000, seed=13)
    reads, _ = synth.make_reads(genomes, 45, 400, seed=14)
    lens = np.random.default_rng(15).integers(0, 400, 45)
    lens[:3] = (0, 5, 11)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(reads, lens)):
            fh.write(f">m{i} description\n{r[:n].tobytes().decode()}\n")
    return {"refs": refs, "short": short, "mixed": mixed}


def _bytes(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _jax(data, reads, **kw) -> str:
    out = io.StringIO()
    assert jax_run(JaxConfig(ref_files=[data["refs"]], in_stream=True, batch_size=BATCH, **kw),
                   out=out, stdin=io.BytesIO(_bytes(data[reads]))) == 0
    return out.getvalue()


def _port(data, reads, **kw) -> str:
    out = io.StringIO()
    assert run(StreamConfig(ref_files=[data["refs"]], in_stream=True, batch_size=BATCH,
                            device="cpu", **kw), out=out,
               stdin=io.BytesIO(_bytes(data[reads]))) == 0
    return out.getvalue()


def _file_mode(data, reads, **kw) -> str:
    out = io.StringIO()
    assert run(StreamConfig(ref_files=[data["refs"]], read_files=[data[reads]],
                            batch_size=BATCH, device="cpu", **kw), out=out) == 0
    return out.getvalue()


@pytest.mark.parametrize("reads,kw", [
    ("short", dict(ks=(12,), sketch_size=1000)),
    ("mixed", dict(ks=(12,), sketch_size=50)),
    ("short", dict(ks=(12, 16), sketch_size=200, min_matches=5, min_diff=2)),
], ids=["k12", "mixed-s50", "multi-k-N-D"])
def test_stream_i_matches_jax_and_file_mode(data, reads, kw):
    got = _port(data, reads, **kw)
    assert got == _jax(data, reads, **kw)
    assert got == _file_mode(data, reads, **kw)
    assert len(got.splitlines()) == (60 if reads == "short" else 45)
    assert 0 < stream.last_peak_buffered_lines <= 3 * BATCH


def test_stream_i_with_M_buffers_and_matches(data, capsys):
    kw = dict(ks=(12,), sketch_size=200, min_kmer_occ=2, counter_size=4099)
    capsys.readouterr()
    got = _port(data, "short", **kw)
    line = ("stream -i with -M: global depth counting buffers the stream (two passes); "
            "output is emitted after EOF.")
    assert line in capsys.readouterr().err.splitlines()
    assert got == _jax(data, "short", **kw) == _file_mode(data, "short", **kw)
    assert got != _port(data, "short", ks=(12,), sketch_size=200)  # -M changed lines


def test_stream_i_empty_stdin_writes_nothing(data):
    for fn, cfg in ((jax_run, JaxConfig), (run, StreamConfig)):
        out = io.StringIO()
        kw = {"device": "cpu"} if cfg is StreamConfig else {}
        assert fn(cfg(ref_files=[data["refs"]], ks=(12,), in_stream=True, **kw), out=out,
                  stdin=io.BytesIO(b"")) == 0
        assert out.getvalue() == ""


def test_stream_i_raises_a_parse_error_after_the_lines_before_it(data):
    """The lines of the whole batches before the bad record are written (as
    rkmh-tpu does, the partial batch is not), then the error is raised."""
    good = _bytes(data["short"]).splitlines(keepends=True)[:4 * 10]
    bad = b"".join(good) + b"not a fastq line\n"
    outs = []
    for fn, cfg in ((jax_run, JaxConfig), (run, StreamConfig)):
        out = io.StringIO()
        kw = {"device": "cpu"} if cfg is StreamConfig else {}
        with pytest.raises(ValueError, match="unrecognized"):
            fn(cfg(ref_files=[data["refs"]], ks=(12,), in_stream=True, batch_size=BATCH, **kw),
               out=out, stdin=io.BytesIO(bad))
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[1].count("\n") == 10 // BATCH * BATCH


def test_stream_i_resume_is_refused(data, tmp_path, capsys):
    capsys.readouterr()
    assert run(StreamConfig(ref_files=[data["refs"]], in_stream=True, resume=True,
                            out_file=str(tmp_path / "o.tsv"), device="cpu"),
               stdin=io.BytesIO(b"")) == 1
    assert "cannot combine with -i" in capsys.readouterr().err
    assert not (tmp_path / "o.tsv").exists()


def test_stream_i_writes_lines_while_the_source_stalls(data):
    """A source that stops without EOF (tail -f): the lines of the records
    already read come out, and only then does the source go on."""
    raw = _bytes(data["short"]).splitlines(keepends=True)
    part1, part2 = b"".join(raw[:4 * 3]), b"".join(raw[4 * 3:])
    released = threading.Event()

    class StallingSource:
        def __init__(self):
            self.buf = io.BytesIO(part1)
            self.stalled = False

        def readline(self):
            line = self.buf.readline()
            if line or self.stalled:
                return line
            self.stalled = True
            assert released.wait(60), "no output while input stalled"
            self.buf = io.BytesIO(part2)
            return self.buf.readline()

    class SignalOut(io.StringIO):
        def write(self, s):
            if s:
                released.set()
            return super().write(s)

    out = SignalOut()
    t = threading.Thread(target=run, args=(StreamConfig(
        ref_files=[data["refs"]], ks=(12,), in_stream=True, batch_size=BATCH, device="cpu"),),
        kwargs=dict(out=out, stdin=StallingSource()), daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "stream -i deadlocked on a stalled source"
    assert released.is_set()
    assert out.getvalue() == _file_mode(data, "short", ks=(12,))


@pytest.mark.parametrize("command", ["stream", "classify"])
def test_cli_i_reads_the_process_stdin(data, monkeypatch, capsys, command):
    argv = [command, "-r", data["refs"], "-i", "-k", "12", "-s", "1000"]
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(_bytes(data["short"]))))
    assert jax_main([*argv, "--batch-size", str(BATCH)]) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(_bytes(data["short"]))))
    assert cli.main([*argv, "--batch-size", str(BATCH), "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want and len(got.out.splitlines()) == 60
    assert (command == "classify") == ("alias of stream" in got.err)
