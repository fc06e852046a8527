"""`rkmh-tpu-torch hash` output byte-identical to `rkmh-tpu hash`.

Both packages hash the same synthetic files (rkmh_tpu_torch.synth, made
from a seed): 150 bp FASTQ reads with N bases, and a FASTA file of mixed
lengths (empty and shorter than k included; names with '|', which the
wabbit key rewrites) split over several chunks and batches.  Every mode
runs: the default lines, -k 12 -k 16, -s, -w, -w -c, -s -w -c, --json,
--sourmash, -o PREFIX (both schemas), -K, and the default k.  The port
runs its plain path on the CPU.  Also: the native hash-line formatter
against Python's join of unsigned values, the CLI's flags and defaults
against rkmh-tpu's parser, hash -M/-I/-m/-T's warnings, and the flags
still rejected by name on hash, count and search.  Tolerance: none;
stdout, files and stderr lines must be equal.
"""

import io
from pathlib import Path

import numpy as np
import pytest

from rkmh_tpu.cli import build_parser as jax_parser
from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.hash_cmd import HashConfig as JaxConfig
from rkmh_tpu.commands.hash_cmd import run as jax_run
from rkmh_tpu_torch import cli, synth
from rkmh_tpu_torch.commands.hash_cmd import HashConfig, run
from rkmh_tpu_torch.io import native


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("hash")
    refs, short, _, _ = synth.write_workload(str(d / "short"), 60, 150, num_refs=4,
                                             genome_len=1500, seed=3, n_rate=0.02)
    _, genomes = synth.make_panel(4, 1500, seed=3)
    reads, _ = synth.make_reads(genomes, 40, 300, n_rate=0.01, seed=4)
    lens = np.random.default_rng(5).integers(0, 300, 40)
    lens[:4] = (0, 5, 11, 12)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(reads, lens)):
            fh.write(f">m{i}|grp{i % 3} description\n{r[:n].tobytes().decode()}\n")
    return {"refs": refs, "short": short, "mixed": mixed, "dir": d}


def _stderr_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if "cpu_aot_loader" not in ln]


def _both(workload, capsys, reads, **kw):
    files = [workload[r] for r in reads]
    capsys.readouterr()
    want = io.StringIO()
    assert jax_run(JaxConfig(read_files=files, **kw), out=want) == 0
    want_err = _stderr_lines(capsys.readouterr().err)
    got = io.StringIO()
    assert run(HashConfig(read_files=files, device="cpu", **kw), out=got) == 0
    got_err = _stderr_lines(capsys.readouterr().err)
    return want.getvalue(), got.getvalue(), want_err, got_err


@pytest.mark.parametrize("reads,kw", [
    (["short"], dict(ks=(12,))),
    (["short", "mixed"], dict(ks=(12, 16))),
    (["mixed"], dict(ks=(12,), batch_size=8, chunk_reads=13)),
    (["short"], dict(ks=(12,), sketch_size=50)),
    (["mixed"], dict(ks=(12, 16), sketch_size=40, batch_size=8, chunk_reads=13)),
    (["mixed"], dict(ks=(12,), wabbitize=True)),
    (["mixed"], dict(ks=(12,), wabbitize=True, output_counts=True)),
    (["short", "mixed"], dict(ks=(12,), sketch_size=30, wabbitize=True, output_counts=True)),
    (["mixed"], dict(ks=(12,), json_out=True, batch_size=8, chunk_reads=13)),
    (["short"], dict(ks=(12, 16), sketch_size=25, json_out=True)),
    (["short", "mixed"], dict(ks=(12,), sketch_size=25, sourmash_out=True)),
    (["mixed"], dict(ks=(5,), output_kmers=True, chunk_reads=7)),
    (["short"], dict()),
], ids=["default", "multi-k", "short-reads-chunks", "s", "s-multi-k", "w", "w-c", "s-w-c",
        "json", "json-s-multi-k", "sourmash", "K", "default-k"])
def test_hash_output_byte_identical_to_jax(workload, capsys, reads, kw):
    want, got, want_err, got_err = _both(workload, capsys, reads, **kw)
    assert got == want and got_err == want_err
    if not (kw.get("json_out") or kw.get("sourmash_out") or kw.get("output_kmers")):
        n = sum(1 for r in reads for ln in Path(workload[r]).read_text().splitlines()
                if ln[:1] in ("@", ">"))
        assert len(want.splitlines()) == n
    if kw.get("ks") == (12,) and not kw.get("output_kmers"):
        # unsigned decimals: about half of all hashes are >= 2**63
        assert any(int(v) >= 2**63 for v in want.replace(":", " ").split()
                   if v.isdigit() and len(v) >= 19)


def test_hash_reads_shorter_than_k_write_an_empty_line(workload, capsys):
    want, got, _, _ = _both(workload, capsys, ["mixed"], ks=(12,))
    lines = got.splitlines(keepends=True)
    assert lines[:3] == ["m0|grp0\t\n", "m1|grp1\t\n", "m2|grp2\t\n"]
    assert lines[3].count(" ") == 0 and lines[3] != "m3|grp0\t\n"  # 12 bp: one window
    assert got == want


@pytest.mark.parametrize("sourmash", [False, True], ids=["rkmh-json", "sig"])
def test_hash_out_prefix_writes_the_same_file(workload, capsys, tmp_path, sourmash):
    for name, fn, cfg, extra in (("jax", jax_run, JaxConfig, {}),
                                 ("torch", run, HashConfig, {"device": "cpu"})):
        out = io.StringIO()
        assert fn(cfg(read_files=[workload["refs"]], ks=(12,), sketch_size=200,
                      sourmash_out=sourmash, out_prefix=str(tmp_path / name), **extra),
                  out=out) == 0
        assert out.getvalue() == ""
    err = _stderr_lines(capsys.readouterr().err)
    ext = ".sig" if sourmash else ".rkmh.json"
    assert (tmp_path / f"torch{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    assert f"Wrote 4 sketches to {tmp_path / 'torch'}{ext}" in err


def test_native_hash_lines_match_python_join():
    rng = np.random.default_rng(0)
    vals = rng.integers(-(2**63), 2**63 - 1, size=(7, 9), dtype=np.int64)
    vals[0, :3] = (0, -1, np.iinfo(np.int64).min)
    mask = rng.random(vals.shape) < 0.7
    mask[2] = False
    names = [f"r{i}|x" for i in range(7)]
    blob = "".join(names).encode()
    offs = np.cumsum([0] + [len(n) for n in names])
    got = native.format_hash_lines_block(vals, mask, blob, offs).decode()
    u = vals.view(np.uint64)
    want = "".join(f"{n}\t{' '.join(map(str, u[i][mask[i]].tolist()))}\n"
                   for i, n in enumerate(names))
    assert got == want and "18446744073709551615" in got
    # rows 2..4 with absolute offsets into the same blob
    assert native.format_hash_lines_block(vals[2:5], mask[2:5], blob, offs[2:6]).decode() == \
        "".join(want.splitlines(keepends=True)[2:5])
    with pytest.raises(ValueError, match="name offsets"):
        native.format_hash_lines_block(vals, mask, blob, offs[:-1])


def test_hash_resume_needs_an_out_file(capsys):
    assert run(HashConfig(read_files=["x.fq"], resume=True, device="cpu")) == 1
    assert "hash --resume requires -o/--out" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["hash", "-f", "a.fq"],
    ["hash", "-f", "a.fq", "-r", "b.fa", "-k", "12", "-k", "16", "-s", "100", "-t", "4", "-K",
     "-w", "-c", "-o", "pre", "--json", "--sourmash", "--batch-size", "64",
     "--chunk-reads", "9", "--out", "o.txt", "--resume"],
    ["count", "-f", "a.fq"],
    ["count", "-f", "a.fq", "-k", "12", "-t", "2", "--counter-size", "1009", "-o", "t.npz",
     "--dump", "--batch-size", "64", "--chunk-reads", "9"],
    ["search", "-r", "k.txt", "-f", "a.fq"],
    ["search", "-r", "k.txt", "-f", "a.fq", "-k", "12", "-t", "2", "--batch-size", "64",
     "--chunk-reads", "9", "-o", "o.txt", "--resume"],
], ids=["hash-defaults", "hash-flags", "count-defaults", "count-flags", "search-defaults",
        "search-flags"])
def test_cli_parses_rkmh_tpu_flags_and_defaults(argv):
    want = vars(jax_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    assert set(got) - {"device"} == set(want)
    for key, value in want.items():  # --dist-* too, with rkmh-tpu's defaults
        assert got[key] == value, key
    assert got["device"] == "cuda"


@pytest.mark.parametrize("flags", [["-M", "2"], ["-I", "3"], ["-m"], ["-T"], ["-M", "1", "-m", "-T"]])
def test_cli_hash_dead_flags_warn_as_jax(workload, capsys, flags):
    argv = ["hash", "-f", workload["short"], "-k", "12", "-s", "20", *flags]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    warnings = [ln for ln in want.err.splitlines() if ln.startswith("warning")]
    assert warnings and [ln for ln in got.err.splitlines() if ln.startswith("warning")] == warnings
    assert got.out == want.out


@pytest.mark.parametrize("command", ["hash", "count", "search"])
@pytest.mark.parametrize("flag", [["--devices", "2"], ["--dist-coordinator", "h:1"],
                                  ["--dist-procs", "2"], ["--dist-rank", "0"]])
def test_cli_rejects_flags_not_yet_ported(command, flag, workload, capsys, monkeypatch):
    """--devices and --dist-* run since they were ported.  With ``--device
    cpu`` --devices sees one device, logs rkmh-tpu's fallback line and
    prints rkmh-tpu's bytes; --dist-rank 0 alone is one process, as in
    rkmh-tpu (its bytes); a coordinator without a process count, or a count
    without a coordinator, names no group: the drain logs why and exits 1
    before it reads a file or opens a socket (tests/test_torch_dist*.py run
    the groups)."""
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    if flag[0] in ("--devices", "--dist-rank"):
        kmers = str(workload["dir"] / "kmers.txt")
        seq = "".join(open(workload["refs"]).read().split(">")[1].split("\n")[1:])
        with open(kmers, "w") as fh:
            fh.write("\n".join(seq[i: i + 12] for i in range(0, 1200, 5)) + "\n")
        argv = ([command, "-r", kmers, "-f", workload["short"], "-k", "12", *flag]
                if command == "search" else
                [command, "-f", workload["short"], "-k", "12", *flag]
                + (["--dump"] if command == "count" else []))
        assert jax_main(argv) == 0
        want = capsys.readouterr().out
        assert cli.main([*argv, "--device", "cpu"]) == 0
        got = capsys.readouterr()
        assert got.out == want and want
        assert (("--devices ignored (--devices 2 > 1 visible device(s)); running single-device"
                 in got.err.splitlines()) == (flag[0] == "--devices"))
        return
    assert cli.main([command, "-r", "k.txt", "-f", "reads.fq", *flag, "--device", "cpu"]
                    if command == "search" else
                    [command, "-f", "reads.fq", *flag, "--device", "cpu"]) == 1
    reason = ("--dist-coordinator h:1 needs --dist-procs (or JAX_NUM_PROCESSES)"
              if flag[0] == "--dist-coordinator" else
              "--dist-procs 2 needs --dist-coordinator host:port (or JAX_COORDINATOR_ADDRESS)")
    assert capsys.readouterr().err.splitlines() == [f"{command} --dist-*: {reason}"]
