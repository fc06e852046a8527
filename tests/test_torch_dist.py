"""Two port ranks (gloo on the CPU) against rkmh-tpu's one-process output.

One pair of rank processes (``tests/torch_dist_worker.py``; the group's
rendezvous on a loopback port) runs every drain of this file in turn over a synthetic workload (12 references, 300
reads of 150 bp and a second file of 30 reads of 700 bp): ``stream``
through the CLI, ``stream -M 2 -I 5`` over both files, ``filter -M 2 -N
3`` (a global batch of 128, so rank 1 owns no real row of the last
batch), ``stream`` and ``filter`` at tp = 2 on local grids of 4 and 2 CPU
entries, a refusal (the ranks see different device counts), and both
--resume paths: stream's stripes cut (rank 1 mid-line) with its -M
checkpoint restored, filter's idx torn on rank 0 and over-claiming a cut
stripe on rank 1; then ``count -o`` through the CLI (rank 0 writes the
table) and a count the group refuses (a 100,001-slot table over dp = 8).
Each merged output (``rkmh-tpu-torch-dist-merge``, and rkmh-tpu's merge
tool on the same stripes) must equal rkmh-tpu's one-process output byte for
byte, and count's table rkmh-tpu's one-process table.  Tolerance: none;
outputs are text and integer arrays.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import torch_dist_worker
from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.dist_stream import merge_main as jax_merge_main
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands.dist_stream import merge_main

COUNTER = 100_000
FRESH = {  # name: (command, extra flags)
    "cli": ("stream", []),
    "mi": ("stream", ["-M", "2", "-I", "5", "--counter-size", str(COUNTER)]),
    "filter": ("filter", ["-M", "2", "-N", "3", "--counter-size", str(COUNTER)]),
    "tp": ("stream", ["-M", "2", "--counter-size", str(COUNTER)]),
    "ftp": ("filter", ["-N", "3"]),
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    refs, reads, _, _ = synth.write_workload(d, 300, num_refs=12)
    _, genomes = synth.make_panel(12)
    long = os.path.join(d, "long.fq")
    synth.write_fastq(long, synth.make_reads(genomes, 30, 700, seed=9)[0], first=300)
    base = dict(ref_files=[refs], read_files=[reads], ks=[12], sketch_size=200, device="cpu")
    out = {name: os.path.join(d, name + ".out")
           for name in (*FRESH, "nope", "sr", "fr", "count", "cnope")}
    m2 = dict(min_kmer_occ=2, counter_size=COUNTER)
    jobs = [
        {"cli": ["stream", "-r", refs, "-f", reads, "-k", "12", "-s", "200", "--batch-size",
                 "64", "-o", out["cli"], "--device", "cpu"]},
        {"run": "stream", "cfg": {**base, "read_files": [reads, long], "batch_size": 64,
                                  "max_samples": 5, "out_file": out["mi"], **m2}},
        {"run": "filter", "cfg": {**base, "batch_size": 128, "min_matches": 3,
                                  "out_file": out["filter"], **m2}},
        {"run": "stream", "cfg": {**base, "batch_size": 64, "tp": 2, "out_file": out["tp"],
                                  **m2}, "mesh": 4},
        {"run": "filter", "cfg": {**base, "batch_size": 128, "tp": 2, "min_matches": 3,
                                  "out_file": out["ftp"]}, "mesh": 2},
        {"run": "stream", "cfg": {**base, "out_file": out["nope"]}, "mesh": [2, 4]},
        # stream --resume: rank 0 cut after 100 lines, rank 1 mid-line at 40%
        {"run": "stream", "cfg": {**base, "batch_size": 64, "out_file": out["sr"], **m2}},
        {"cut": out["sr"] + ".0", "rank": 0, "lines": 100},
        {"cut": out["sr"] + ".1", "rank": 1, "lines": 56, "torn": True},
        {"run": "stream", "cfg": {**base, "batch_size": 64, "out_file": out["sr"], **m2,
                                  "resume": True}},
        # filter --resume: rank 0's idx torn after 1 batch; rank 1's stripe cut
        # under what its whole idx claims (the rank restarts)
        {"run": "filter", "cfg": {**base, "batch_size": 128, "min_matches": 3,
                                  "out_file": out["fr"], **m2}},
        {"cut": out["fr"] + ".0.idx", "rank": 0, "lines": 1, "torn": True},
        {"cut": out["fr"] + ".1", "rank": 1, "lines": 6},
        {"run": "filter", "cfg": {**base, "batch_size": 128, "min_matches": 3,
                                  "out_file": out["fr"], **m2, "resume": True}},
        {"cli": ["count", "-f", reads, "-k", "12", "--batch-size", "64", "--counter-size",
                 str(COUNTER), "-o", out["count"] + ".npz", "--device", "cpu"]},
        {"run": "count", "cfg": dict(read_files=[reads], ks=[12], batch_size=64,
                                     counter_size=COUNTER + 1, out_file=out["cnope"] + ".npz",
                                     device="cpu"), "mesh": 4},
    ]
    snapshots = {}
    ranks = torch_dist_worker.run_pair(jobs, d, store="tcp")
    for name in (*FRESH, "sr", "fr"):
        snapshots[name] = {r: open(f"{out[name]}.{r}").read() for r in range(2)}
    return {"dir": d, "refs": refs, "reads": reads, "long": long, "out": out, "ranks": ranks,
            "jobs": jobs, "stripes": snapshots}


def _jax(pair, command, flags, reads=None) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main([command, "-r", pair["refs"], *[a for r in (reads or [pair["reads"]])
                                                         for a in ("-f", r)],
                         "-k", "12", "-s", "200", *flags]) == 0
    return buf.getvalue()


def _merged(merge, out: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert merge([f"{out}.0", f"{out}.1"]) == 0
    return buf.getvalue()


def test_every_job_ran(pair):
    for r, (results, _) in enumerate(pair["ranks"]):
        assert len(results) == len(pair["jobs"]), (r, results)
        rcs = [res["rc"] for res in results]
        assert rcs == [0] * 5 + [1] + [0] * 9 + [1], (r, results)


@pytest.mark.parametrize("name", list(FRESH))
def test_merged_stripes_equal_jax_one_process(pair, name):
    command, flags = FRESH[name]
    reads = [pair["reads"], pair["long"]] if name == "mi" else None
    want = _jax(pair, command, flags, reads)
    assert _merged(merge_main, pair["out"][name]) == want
    assert _merged(jax_merge_main, pair["out"][name]) == want
    n_lines = len(want.splitlines())
    if command == "stream":
        assert n_lines == (330 if name == "mi" else 300)
    else:
        assert 0 < n_lines < 4 * 300 and n_lines % 4 == 0


def test_stripes_and_sidecar_geometry(pair):
    """Rank r holds rows [r * Bl, (r + 1) * Bl) of each global batch; the
    sidecar is rkmh-tpu's JSON, byte for byte."""
    out = pair["out"]
    assert [len(pair["stripes"]["cli"][r].splitlines()) for r in range(2)] == [160, 140]
    for name, B, fmt in (("cli", 64, "stream"), ("mi", 64, "stream"), ("filter", 128, "filter"),
                         ("tp", 64, "stream"), ("ftp", 128, "filter")):
        with open(out[name] + ".dist.json") as fh:
            assert fh.read() == json.dumps({"global_batch": B, "procs": 2, "format": fmt})


def test_filter_idx_has_a_line_for_every_global_batch(pair):
    """300 reads in global batches of 128: rank 1 owns rows 320-383 of the
    last batch, all padding, and still writes its idx line 0."""
    for name in ("filter", "ftp"):
        idx = [open(f"{pair['out'][name]}.{r}.idx").read().split() for r in range(2)]
        assert [len(i) for i in idx] == [3, 3]
        assert idx[1][2] == "0"
        stripes = pair["stripes"][name]
        assert [sum(map(int, i)) * 4 for i in idx] == [len(stripes[r].splitlines())
                                                       for r in range(2)]


def test_local_device_counts_must_agree(pair):
    line = ("stream --dist-*: the ranks see 2 to 4 local devices; every rank needs the same "
            "count (each owns an equal block of every global batch)")
    for _, err in pair["ranks"]:
        assert line in err.splitlines()
    assert not os.path.exists(pair["out"]["nope"] + ".0")


def test_stream_resume_restores_counter_and_matches(pair):
    want = _jax(pair, "stream", ["-M", "2", "--counter-size", str(COUNTER)])
    assert _merged(merge_main, pair["out"]["sr"]) == want
    assert pair["stripes"]["sr"] == pair["stripes"]["tp"]  # tp and dp do not change stripes
    errs = [err.splitlines() for _, err in pair["ranks"]]
    for r in range(2):
        path = f"{pair['out']['sr']}.mctr.{r}.npz"
        assert (f"dist rank {r}: -M counter restored from {path}; counting pass skipped"
                in errs[r])
    assert f"dist rank 0: resuming, 100 lines already landed in {pair['out']['sr']}.0" in errs[0]
    assert f"dist rank 1: resuming, 56 lines already landed in {pair['out']['sr']}.1" in errs[1]
    # rank 1's 56 lines end inside batch 1 (32 + 24 of its 32), so both ranks
    # restart dispatch at batch 1 and rank 0 skips its overhang
    assert "dist rank 0: watermark — dispatch resumes at batch 1 (68 overhang lines to skip)" \
        in errs[0]


def test_filter_resume_torn_idx_and_overclaim(pair):
    want = _jax(pair, "filter", ["-M", "2", "-N", "3", "--counter-size", str(COUNTER)])
    out = pair["out"]["fr"]
    assert _merged(merge_main, out) == want
    assert pair["stripes"]["fr"] == pair["stripes"]["filter"]
    errs = [err.splitlines() for _, err in pair["ranks"]]
    assert any(ln.startswith(f"dist rank 0: resuming, 1 batches (") for ln in errs[0])
    claim = sum(map(int, open(f"{out}.1.idx").read().split())) * 4
    assert (f"dist rank 1: stripe holds 6 lines but {out}.1.idx covers {claim}; restarting "
            "this rank's stripe from scratch") in errs[1]
    for r in range(2):
        assert len(open(f"{out}.{r}.idx").read().split()) == 3


def test_cli_count_table_equals_jax_one_process(pair, tmp_path):
    """count through the CLI with the ranks' --dist-* flags: rank 0 writes
    the table of every rank's reads, rkmh-tpu's one-process table."""
    want = str(tmp_path / "one.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(["count", "-f", pair["reads"], "-k", "12", "--counter-size",
                         str(COUNTER), "-o", want]) == 0
    with np.load(pair["out"]["count"] + ".npz") as got, np.load(want) as one:
        for key in ("table", "size", "ks"):
            np.testing.assert_array_equal(got[key], one[key])
        assert int(got["table"].sum()) == 300 * 139


def test_count_refused_after_the_group(pair):
    line = f"count --dist-*: counter size {COUNTER + 1} is not divisible by the 8 dp shards"
    for _, err in pair["ranks"]:
        assert line in err.splitlines()
    assert not os.path.exists(pair["out"]["cnope"] + ".npz")
