"""Port ranks against a real two-process rkmh-tpu run: ``stream -M 2 --tp 2``.

rkmh-tpu runs ``stream -k 12 -s 200 --batch-size 64 --tp 2 -M 2
--counter-size 100000 --dist-*`` as two processes of 4 virtual CPU devices
each (its CPU collectives on gloo); the port runs two ranks on local grids
of 4 CPU entries (``tests/torch_dist_worker.py``), the same geometry (dp =
4, tp = 2, a global batch of 64).  Their stripes, ``.dist.json`` and the
-M checkpoints (``rows`` and ``fp``) must be equal byte for byte, both
merge tools must give the same bytes on rkmh-tpu's stripes, and a port
``--resume`` over rkmh-tpu's cut stripes and checkpoints must restore the
counter (no counting pass) and finish rkmh-tpu's stripes as rkmh-tpu
wrote them.  Tolerance: none.
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
FLAGS = ["-k", "12", "-s", "200", "--batch-size", "64", "--tp", "2", "-M", "2",
         "--counter-size", str(COUNTER)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_jax_stream"))
    refs, reads, _, _ = synth.write_workload(d, 300, num_refs=12)
    jax_out, port_out, resumed = (os.path.join(d, n) for n in ("jax.rk", "port.rk", "res.rk"))
    jax_err = torch_dist_worker.run_jax_pair(["stream", "-r", refs, "-f", reads, *FLAGS,
                                              "-o", jax_out], d)
    for suffix in (".0", ".1", ".dist.json", ".mctr.0.npz", ".mctr.1.npz"):
        shutil.copy(jax_out + suffix, resumed + suffix)
    cfg = dict(ref_files=[refs], read_files=[reads], ks=[12], sketch_size=200, batch_size=64,
               tp=2, min_kmer_occ=2, counter_size=COUNTER, device="cpu")
    ranks = torch_dist_worker.run_pair([
        {"run": "stream", "cfg": {**cfg, "out_file": port_out}, "mesh": 4},
        {"cut": resumed + ".0", "rank": 0, "lines": 64},
        {"cut": resumed + ".1", "rank": 1, "lines": 56, "torn": True},
        {"run": "stream", "cfg": {**cfg, "out_file": resumed, "resume": True}, "mesh": 4},
    ], d)
    return {"jax": jax_out, "port": port_out, "resumed": resumed, "jax_err": jax_err,
            "ranks": ranks}


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


@pytest.mark.parametrize("suffix", [".0", ".1", ".dist.json"])
def test_stripes_and_sidecar_equal_jax(runs, suffix):
    want = _read(runs["jax"] + suffix, "rb")
    assert _read(runs["port"] + suffix, "rb") == want and want
    if suffix != ".dist.json":
        assert len(want.splitlines()) == (160 if suffix == ".0" else 140)


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
    assert got[0] == got[1] and len(got[0].splitlines()) == 300


def test_port_resumes_jax_stripes_from_its_checkpoints(runs):
    errs = [err.splitlines() for _, err in runs["ranks"]]
    assert [res["rc"] for res in runs["ranks"][0][0]] == [0, 0, 0, 0]
    for r in range(2):
        path = f"{runs['resumed']}.mctr.{r}.npz"
        assert f"dist rank {r}: -M counter restored from {path}; counting pass skipped" in errs[r]
        assert _read(f"{runs['resumed']}.{r}", "rb") == _read(f"{runs['jax']}.{r}", "rb")
    assert any("watermark — dispatch resumes at batch 1" in ln for ln in errs[0])
