"""Port ranks against a real two-process rkmh-tpu run: ``count -o --dump``.

rkmh-tpu runs ``count -k 12 --batch-size 64 --counter-size 100000 -o T.npz
--dump --dist-*`` as two processes of 4 virtual CPU devices each (its
per-batch ``psum_scatter``, then a gather); the port runs two ranks on
local grids of 4 CPU entries (each rank's rows counted over its grid's
slot ranges, then one ``all_reduce``).  The tables (``table``, ``size``,
``ks``) must be equal and equal to rkmh-tpu's one-process table, the
``--dump`` lines on rank 0's stdout equal (rank 1 prints none), and each
rank's ``counted`` line equal.  Tolerance: none.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

import torch_dist_worker
from rkmh_tpu.cli import main as jax_main
from rkmh_tpu_torch import synth

COUNTER = 100_000
FLAGS = ["-k", "12", "--batch-size", "64", "--counter-size", str(COUNTER)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_jax_count"))
    _, reads, _, _ = synth.write_workload(d, 300, num_refs=12)
    out = {n: os.path.join(d, n) for n in ("jax.npz", "port.npz", "one.npz", "jax.dump",
                                            "port.dump")}
    jax_err = torch_dist_worker.run_jax_pair(
        ["count", "-f", reads, *FLAGS, "-o", out["jax.npz"], "--dump"], d,
        stdout=out["jax.dump"])
    ranks = torch_dist_worker.run_pair([
        {"run": "count", "cfg": dict(read_files=[reads], ks=[12], batch_size=64,
                                     counter_size=COUNTER, out_file=out["port.npz"], dump=True,
                                     device="cpu"), "mesh": 4, "stdout": out["port.dump"]},
    ], d)
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(["count", "-f", reads, *FLAGS, "-o", out["one.npz"]]) == 0
    return {"out": out, "jax_err": jax_err, "ranks": ranks}


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _read(path) -> str:
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize("other", ["jax.npz", "one.npz"])
def test_table_equals_jax(runs, other):
    got, want = _arrays(runs["out"]["port.npz"]), _arrays(runs["out"][other])
    assert sorted(got) == sorted(want) == ["ks", "size", "table"]
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    assert got["table"].shape == (COUNTER,) and int(got["table"].sum()) == 300 * 139


def test_dump_lines_equal_jax(runs):
    """rkmh-tpu's stdout also carries gloo's connection notes; its dump
    lines are the ``slot\\tcount`` ones."""
    dump = re.compile(r"^\d+\t\d+$")
    want = [ln for ln in _read(runs["out"]["jax.dump"] + ".0").splitlines() if dump.match(ln)]
    got = _read(runs["out"]["port.dump"] + ".0").splitlines()
    assert got == want and len(want) == int((_arrays(runs["out"]["jax.npz"])["table"] > 0).sum())
    assert _read(runs["out"]["port.dump"] + ".1") == ""
    assert not any(dump.match(ln) for ln in _read(runs["out"]["jax.dump"] + ".1").splitlines())


@pytest.mark.parametrize("rank", [0, 1])
def test_counted_line_equals_jax(runs, rank):
    def counted(err):
        return [ln for ln in err.splitlines() if ln.startswith(f"dist rank {rank}")]

    want = counted(runs["jax_err"][rank])
    assert counted(runs["ranks"][rank][1]) == want and len(want) == 2
    reads = 160 if rank == 0 else 140
    assert want[1].startswith(f"dist rank {rank}: counted {reads * 139} kmers from {reads} "
                              "owned reads; global 100000-slot table has ")
