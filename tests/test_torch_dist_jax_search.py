"""Port ranks against a real two-process rkmh-tpu run: ``search -o``.

rkmh-tpu runs ``search -r KMERS -f reads.fq -f short.fq -k 12 --batch-size
64 -o FILE --dist-*`` as two processes of 4 virtual CPU devices each; the
port runs two ranks on local grids of 4 CPU entries.  The second file's 40
reads of 10 bp are shorter than k and write no line, so the stripes have
variable length and each rank's ``.idx`` counts its lines in every global
batch (rank 1's rows of the last batch are all short: its line is 0).
Stripes, ``.idx`` files and ``.dist.json`` must be equal byte for byte,
both merge tools must give rkmh-tpu's one-process lines on rkmh-tpu's
stripes, and a port ``--resume`` over rkmh-tpu's cut stripes (rank 0's idx
torn after one batch; rank 1's stripe cut under what its idx claims, so
the rank restarts) must finish them as rkmh-tpu wrote them.  Tolerance:
none.
"""

import contextlib
import io
import os
import shutil

import pytest

import torch_dist_worker
from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.dist_stream import merge_main as jax_merge_main
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands.dist_stream import merge_main

SUFFIXES = (".0", ".1", ".0.idx", ".1.idx", ".dist.json")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_jax_search"))
    refs, reads, _, _ = synth.write_workload(d, 280, num_refs=12)
    _, genomes = synth.make_panel(12)
    short = os.path.join(d, "short.fq")
    synth.write_fastq(short, synth.make_reads(genomes, 40, 10, seed=9)[0], first=280)
    kmers = os.path.join(d, "kmers.txt")
    seq = "".join(open(refs).read().split(">")[1].split()[1:])
    with open(kmers, "w") as fh:
        fh.write("".join(seq[i:i + 12] + "\n" for i in range(0, 6000, 7)))
    argv = ["-r", kmers, "-f", reads, "-f", short, "-k", "12", "--batch-size", "64"]
    jax_out, port_out, resumed = (os.path.join(d, n) for n in ("jax.txt", "port.txt", "res.txt"))
    torch_dist_worker.run_jax_pair(["search", *argv, "-o", jax_out], d)
    for suffix in SUFFIXES:
        shutil.copy(jax_out + suffix, resumed + suffix)
    cfg = dict(ref_files=[kmers], read_files=[reads, short], ks=[12], batch_size=64,
               device="cpu")
    ranks = torch_dist_worker.run_pair([
        {"run": "search", "cfg": {**cfg, "out_file": port_out}, "mesh": 4},
        {"cut": resumed + ".0.idx", "rank": 0, "lines": 1, "torn": True},
        {"cut": resumed + ".1", "rank": 1, "lines": 3},
        {"run": "search", "cfg": {**cfg, "out_file": resumed, "resume": True}, "mesh": 4},
    ], d)
    return {"argv": argv, "jax": jax_out, "port": port_out, "resumed": resumed,
            "ranks": ranks}


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_stripes_idx_and_sidecar_equal_jax(runs, suffix):
    want = _read(runs["jax"] + suffix, "rb")
    assert _read(runs["port"] + suffix, "rb") == want and want
    if suffix.endswith(".idx"):
        counts = want.split()
        assert len(counts) == 5 and (suffix != ".1.idx" or counts[-1] == b"0")


def test_merge_tools_agree_on_jax_stripes(runs):
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        assert jax_main(["search", *runs["argv"]]) == 0
    got = []
    for main in (merge_main, jax_merge_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([runs["jax"] + ".0", runs["jax"] + ".1"]) == 0
        got.append(buf.getvalue())
    assert got[0] == got[1] == want.getvalue()
    assert len(got[0].splitlines()) == 280  # the 40 short reads write nothing


def test_port_resumes_jax_stripes(runs):
    assert [res["rc"] for res in runs["ranks"][0][0]] == [0] * 4
    for suffix in SUFFIXES:
        assert _read(runs["resumed"] + suffix, "rb") == _read(runs["jax"] + suffix, "rb")
    errs = [err.splitlines() for _, err in runs["ranks"]]
    path = runs["resumed"]
    assert any(ln.startswith(f"dist rank 0: resuming, 1 batches (") and ln.endswith(
        f" lines) already landed in {path}.0") for ln in errs[0])
    assert any(ln.startswith(f"dist rank 1: stripe holds 3 lines but {path}.1.idx covers ")
               for ln in errs[1])
