"""Port ranks against a real two-process rkmh-tpu run: ``filter -M 2 -N 3``.

rkmh-tpu runs ``filter -k 12 -s 200 --batch-size 128 -M 2 -N 3
--counter-size 100000 --dist-*`` as two processes of 4 virtual CPU devices
each; the port runs two ranks on local grids of 4 CPU entries (dp = 8,
tp = 1; the -M counter over 4 dp slot ranges on each rank).  300 reads in
global batches of 128: rank 1 owns only padding in the last batch and
writes its idx line 0.  The stripes, ``.idx`` files, ``.dist.json`` and
-M checkpoints must be equal byte for byte, both merge tools must give
the same bytes on rkmh-tpu's stripes, and a port ``--resume`` over
rkmh-tpu's stripes (rank 0's idx torn, rank 1's idx lost) must finish
them as rkmh-tpu wrote them.  Tolerance: none.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

import torch_dist_worker
from rkmh_tpu.commands.dist_stream import merge_main as jax_merge_main
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands.dist_stream import merge_main

COUNTER = 100_000
FLAGS = ["-k", "12", "-s", "200", "--batch-size", "128", "-M", "2", "-N", "3",
         "--counter-size", str(COUNTER)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_jax_filter"))
    refs, reads, _, _ = synth.write_workload(d, 300, num_refs=12)
    jax_out, port_out, resumed = (os.path.join(d, n) for n in ("jax.fq", "port.fq", "res.fq"))
    torch_dist_worker.run_jax_pair(["filter", "-r", refs, "-f", reads, *FLAGS, "-o", jax_out],
                                   d)
    for suffix in (".0", ".1", ".0.idx", ".dist.json", ".mctr.0.npz", ".mctr.1.npz"):
        shutil.copy(jax_out + suffix, resumed + suffix)
    cfg = dict(ref_files=[refs], read_files=[reads], ks=[12], sketch_size=200,
               batch_size=128, min_kmer_occ=2, min_matches=3, counter_size=COUNTER,
               device="cpu")
    ranks = torch_dist_worker.run_pair([
        {"run": "filter", "cfg": {**cfg, "out_file": port_out}, "mesh": 4},
        {"cut": resumed + ".0.idx", "rank": 0, "lines": 1, "torn": True},
        {"run": "filter", "cfg": {**cfg, "out_file": resumed, "resume": True}, "mesh": 4},
    ], d)
    return {"jax": jax_out, "port": port_out, "resumed": resumed, "ranks": ranks}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("suffix", [".0", ".1", ".0.idx", ".1.idx", ".dist.json"])
def test_stripes_idx_and_sidecar_equal_jax(runs, suffix):
    want = _read(runs["jax"] + suffix)
    assert _read(runs["port"] + suffix) == want and want
    if suffix == ".1.idx":
        assert want.split()[-1] == b"0" and len(want.split()) == 3


@pytest.mark.parametrize("rank", [0, 1])
def test_counter_checkpoints_equal_jax(runs, rank):
    with np.load(f"{runs['jax']}.mctr.{rank}.npz") as a, \
            np.load(f"{runs['port']}.mctr.{rank}.npz") as b:
        assert bytes(a["fp"]) == bytes(b["fp"])
        np.testing.assert_array_equal(a["rows"], b["rows"])
        assert b["rows"].dtype == np.int32 and b["rows"].shape == (COUNTER // 2,)


def test_merge_tools_agree_on_jax_stripes(runs):
    got = []
    for main in (merge_main, jax_merge_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([runs["jax"] + ".0", runs["jax"] + ".1"]) == 0
        got.append(buf.getvalue())
    assert got[0] == got[1] and got[0] and len(got[0].splitlines()) % 4 == 0


def test_port_resumes_jax_stripes(runs):
    errs = [err.splitlines() for _, err in runs["ranks"]]
    assert any(ln.startswith("dist rank 0: resuming, 1 batches (") for ln in errs[0])
    assert (f"dist rank 1: --resume without {runs['resumed']}.1.idx; restarting this rank's "
            "stripe from scratch") in errs[1]
    for suffix in (".0", ".1", ".0.idx", ".1.idx"):
        assert _read(runs["resumed"] + suffix) == _read(runs["jax"] + suffix)
