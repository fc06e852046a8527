"""Port ranks against a real two-process rkmh-tpu run: ``call -o``.

rkmh-tpu runs ``call -r two.fa -f reads.fq -k 16 -o FILE --dist-*`` as two
processes of 4 virtual CPU devices each (dp = 8 slices of a reference's
positions, the window halo over the mesh by ``ppermute``); the port runs
two ranks on local grids of 4 CPU entries (each rank its 4 slices, the
first slice's halo made from the whole map).  ``two.fa`` holds a 400 bp
reference first (385 positions: 49 a slice, under the 100-position window,
so rank 0 owns them all and rank 1 writes an empty section) and then the
7,992 bp HPV16REF of ``synth --call`` (7,977 positions, which 8 does not
divide).  Stripes and ``.dist.json`` must be equal byte for byte, both
merge tools must give rkmh-tpu's one-process VCF on rkmh-tpu's stripes,
and a port ``--resume`` over rkmh-tpu's stripes, rank 1's cut inside its
second section, must finish them as rkmh-tpu wrote them.  Tolerance: none.
"""

import contextlib
import io
import json
import os
import shutil

import pytest

import torch_dist_worker
from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.dist_stream import merge_main as jax_merge_main
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands.dist_stream import merge_main


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_jax_call"))
    ref, reads, _, _ = synth.write_call_workload(d, n_reads=200)
    with open(ref) as fh:
        text = fh.read()
    two = os.path.join(d, "two.fa")
    with open(two, "w") as fh:
        fh.write(">short\n" + "".join(text.split("\n")[1:])[1000:1400] + "\n" + text)
    argv = ["-r", two, "-f", reads, "-k", "16"]
    jax_out, port_out, resumed = (os.path.join(d, n) for n in ("jax.v", "port.v", "res.v"))
    torch_dist_worker.run_jax_pair(["call", *argv, "-o", jax_out], d)
    for suffix in (".0", ".1", ".dist.json"):
        shutil.copy(jax_out + suffix, resumed + suffix)
    cfg = dict(ref_files=[two], read_files=[reads], ks=[16], device="cpu")
    ranks = torch_dist_worker.run_pair([
        {"run": "call", "cfg": {**cfg, "out_file": port_out}, "mesh": 4},
        {"cut": resumed + ".1", "rank": 1, "lines": 20, "torn": True},
        {"run": "call", "cfg": {**cfg, "out_file": resumed, "resume": True}, "mesh": 4},
    ], d)
    with contextlib.redirect_stdout(io.StringIO()) as one:
        assert jax_main(["call", *argv]) == 0
    return {"jax": jax_out, "port": port_out, "resumed": resumed, "ranks": ranks,
            "one": one.getvalue()}


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


def _sections(path) -> list:
    """(reference, entries) of each ``ref_done`` line of a stripe."""
    return [(e["ref_done"], e["n"]) for e in map(json.loads, _read(path).splitlines())
            if "ref_done" in e]


@pytest.mark.parametrize("suffix", [".0", ".1", ".dist.json"])
def test_stripes_and_sidecar_equal_jax(runs, suffix):
    want = _read(runs["jax"] + suffix, "rb")
    assert _read(runs["port"] + suffix, "rb") == want and want
    if suffix == ".dist.json":
        assert json.loads(want)["devices"] == 8 and json.loads(want)["refs_total"] == 2
    else:
        sections = _sections(runs["jax"] + suffix)
        assert [name for name, _ in sections] == ["short", "HPV16REF"]
        assert (sections[0][1] == 0) == (suffix == ".1") and sections[1][1] > 0


def test_merge_tools_agree_on_jax_stripes(runs):
    got = []
    for main in (merge_main, jax_merge_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([runs["jax"] + ".0", runs["jax"] + ".1"]) == 0
        got.append(buf.getvalue())
    assert got[0] == got[1] == runs["one"]
    assert sum(ln.startswith("HPV16REF\t") for ln in runs["one"].splitlines()) >= 40


def test_port_resumes_jax_stripes(runs):
    assert [res["rc"] for res in runs["ranks"][0][0]] == [0] * 3
    for r in range(2):
        assert _read(f"{runs['resumed']}.{r}", "rb") == _read(f"{runs['jax']}.{r}", "rb")
    errs = [err.splitlines() for _, err in runs["ranks"]]
    assert (f"dist rank 0: resuming, 2 ref section(s) already in {runs['resumed']}.0"
            in errs[0])
    assert (f"dist rank 1: resuming, 1 ref section(s) already in {runs['resumed']}.1"
            in errs[1])
