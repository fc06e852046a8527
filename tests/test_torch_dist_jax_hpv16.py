"""Port ranks against a real two-process rkmh-tpu run: ``hpv16 --tp 2 -M 2``.

rkmh-tpu runs ``hpv16 -k 16 --batch-size 8 --tp 2 -M 2 --counter-size 4096
-o FILE --dist-*`` as two processes of 4 virtual CPU devices each (a (4,
2) global mesh: the set table in 2 column shards, the counter in 4 dp
shards), on ``synth.write_hpv16_refpath``'s small panel (12 types x 2 kb,
10 sublineages) and 40 nanopore-like reads; the port runs two ranks on
local grids of 4 CPU entries at tp = 2.  Stripes, ``.dist.json``, the
``.tst`` side file and the -M checkpoints (``fp`` and ``rows``) must be
equal byte for byte, both merge tools must give rkmh-tpu's one-process
lines on rkmh-tpu's stripes, and a port ``--resume`` over rkmh-tpu's cut
stripes and checkpoints must restore the counter (no counting pass) and
finish the stripes as rkmh-tpu wrote them.  Tolerance: none.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

import torch_dist_worker
from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.dist_stream import merge_main as jax_merge_main
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands.dist_stream import merge_main

COUNTER = 4096
TST = "lineage_specific_hashes.16.tst"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_jax_hpv16"))
    panel = synth.write_hpv16_refpath(os.path.join(d, "refs"), seed=3, num_types=12,
                                      genome_len=2000)
    reads = os.path.join(d, "reads.fq")
    synth.write_fastq_records(reads, synth.make_nanopore_reads(
        40, 5, panel, mean_len=1200, min_len=300, max_len=3000, n_rate=0.01)[0])
    argv = ["-f", reads, "-R", os.path.join(d, "refs"), "-k", "16", "--batch-size", "8",
            "--tp", "2", "-M", "2", "--counter-size", str(COUNTER)]
    wd = {n: os.path.join(d, n) for n in ("jax", "port", "one")}
    for path in wd.values():
        os.makedirs(path)
    jax_out, port_out, resumed = (os.path.join(wd[n], n) for n in ("jax", "port", "port"))
    resumed += ".res"
    torch_dist_worker.run_jax_pair(["hpv16", *argv, "-o", jax_out], d, cwd=wd["jax"])
    for suffix in (".0", ".1", ".dist.json", ".mctr.0.npz", ".mctr.1.npz"):
        shutil.copy(jax_out + suffix, resumed + suffix)
    cfg = dict(read_files=[reads], refpath=os.path.join(d, "refs"), ks=[16], batch_size=8,
               tp=2, min_kmer_occ=2, counter_size=COUNTER, device="cpu")
    ranks = torch_dist_worker.run_pair([
        {"run": "hpv16", "cfg": {**cfg, "out_file": port_out}, "mesh": 4},
        {"cut": resumed + ".0", "rank": 0, "lines": 12},
        {"cut": resumed + ".1", "rank": 1, "lines": 5, "torn": True},
        {"run": "hpv16", "cfg": {**cfg, "out_file": resumed, "resume": True}, "mesh": 4},
    ], d, cwd=wd["port"])
    cwd = os.getcwd()
    try:
        os.chdir(wd["one"])
        with contextlib.redirect_stdout(io.StringIO()) as one:
            assert jax_main(["hpv16", *argv]) == 0
    finally:
        os.chdir(cwd)
    return {"wd": wd, "jax": jax_out, "port": port_out, "resumed": resumed, "ranks": ranks,
            "one": one.getvalue()}


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


@pytest.mark.parametrize("suffix", [".0", ".1", ".dist.json", "tst"])
def test_stripes_sidecar_and_tst_equal_jax(runs, suffix):
    if suffix == "tst":
        want = _read(os.path.join(runs["wd"]["jax"], TST), "rb")
        got = _read(os.path.join(runs["wd"]["port"], TST), "rb")
    else:
        want, got = _read(runs["jax"] + suffix, "rb"), _read(runs["port"] + suffix, "rb")
    assert got == want and want
    if suffix in (".0", ".1"):
        assert len(want.splitlines()) == 20


@pytest.mark.parametrize("rank", [0, 1])
def test_counter_checkpoints_equal_jax(runs, rank):
    with np.load(f"{runs['jax']}.mctr.{rank}.npz") as a, \
            np.load(f"{runs['port']}.mctr.{rank}.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["fp", "rows"]
        assert bytes(a["fp"]) == bytes(b["fp"])
        assert a["rows"].dtype == b["rows"].dtype == np.int32
        assert a["rows"].shape == (COUNTER // 2,)
        np.testing.assert_array_equal(a["rows"], b["rows"])
        assert b["rows"].any()


def test_merge_tools_agree_on_jax_stripes(runs):
    got = []
    for main in (merge_main, jax_merge_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([runs["jax"] + ".0", runs["jax"] + ".1"]) == 0
        got.append(buf.getvalue())
    assert got[0] == got[1] == runs["one"] and len(runs["one"].splitlines()) == 40


def test_port_resumes_jax_stripes_from_its_checkpoints(runs):
    assert [res["rc"] for res in runs["ranks"][0][0]] == [0] * 4
    errs = [err.splitlines() for _, err in runs["ranks"]]
    for r in range(2):
        path = f"{runs['resumed']}.mctr.{r}.npz"
        assert f"dist rank {r}: -M counter restored from {path}; counting pass skipped" in errs[r]
        assert _read(f"{runs['resumed']}.{r}", "rb") == _read(f"{runs['jax']}.{r}", "rb")
    # rank 1's 5 lines end inside batch 1 (4 + 1 of its 4): dispatch restarts there
    assert "dist rank 0: watermark — dispatch resumes at batch 1 (8 overhang lines to skip)" \
        in errs[0]
