"""Port ranks against a real two-process rkmh-tpu run: ``hash --out``.

rkmh-tpu runs ``hash -k 12 --batch-size 64 --out FILE --dist-*`` as two
processes of 4 virtual CPU devices each; the port runs two ranks on local
grids of 4 CPU entries (``tests/torch_dist_worker.py``), the same geometry
(dp = 8, a global batch of 64).  Their stripes and ``.dist.json`` must be
equal byte for byte, both merge tools must give rkmh-tpu's one-process
lines on rkmh-tpu's stripes, and a port ``--resume`` over rkmh-tpu's cut
stripes must finish them as rkmh-tpu wrote them.  The port's ``-s 50 -w
-c`` and (through the CLI) ``-s 50`` stripes, merged, must equal rkmh-tpu's
one-process output.  Tolerance: none.
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

FLAGS = ["-k", "12", "--batch-size", "64"]
MODES = {"sw": ["-s", "50", "-w", "-c"], "s": ["-s", "50"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_jax_hash"))
    _, reads, _, _ = synth.write_workload(d, 300, num_refs=12)
    jax_out, port_out, resumed = (os.path.join(d, n) for n in ("jax.txt", "port.txt", "res.txt"))
    torch_dist_worker.run_jax_pair(["hash", "-f", reads, *FLAGS, "--out", jax_out], d)
    for suffix in (".0", ".1", ".dist.json"):
        shutil.copy(jax_out + suffix, resumed + suffix)
    cfg = dict(read_files=[reads], ks=[12], batch_size=64, device="cpu")
    modes = {m: os.path.join(d, f"{m}.txt") for m in MODES}
    ranks = torch_dist_worker.run_pair([
        {"run": "hash", "cfg": {**cfg, "out_file": port_out}, "mesh": 4},
        {"cut": resumed + ".0", "rank": 0, "lines": 64},
        {"cut": resumed + ".1", "rank": 1, "lines": 56, "torn": True},
        {"run": "hash", "cfg": {**cfg, "out_file": resumed, "resume": True}, "mesh": 4},
        {"run": "hash", "cfg": {**cfg, "sketch_size": 50, "wabbitize": True,
                                "output_counts": True, "out_file": modes["sw"]}, "mesh": 4},
        {"cli": ["hash", "-f", reads, *FLAGS, *MODES["s"], "--out", modes["s"],
                 "--device", "cpu"]},
    ], d)
    return {"reads": reads, "jax": jax_out, "port": port_out, "resumed": resumed,
            "modes": modes, "ranks": ranks}


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


def _merged(main, out: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([out + ".0", out + ".1"]) == 0
    return buf.getvalue()


def _jax_one_process(reads, flags) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main(["hash", "-f", reads, *FLAGS, *flags]) == 0
    return buf.getvalue()


@pytest.mark.parametrize("suffix", [".0", ".1", ".dist.json"])
def test_stripes_and_sidecar_equal_jax(runs, suffix):
    want = _read(runs["jax"] + suffix, "rb")
    assert _read(runs["port"] + suffix, "rb") == want and want
    if suffix != ".dist.json":
        assert len(want.splitlines()) == (160 if suffix == ".0" else 140)


def test_merge_tools_agree_on_jax_stripes(runs):
    want = _jax_one_process(runs["reads"], [])
    assert _merged(merge_main, runs["jax"]) == _merged(jax_merge_main, runs["jax"]) == want
    assert len(want.splitlines()) == 300


def test_port_resumes_jax_stripes(runs):
    assert [res["rc"] for res in runs["ranks"][0][0]] == [0] * 6
    for r in range(2):
        assert _read(f"{runs['resumed']}.{r}", "rb") == _read(f"{runs['jax']}.{r}", "rb")
    errs = [err.splitlines() for _, err in runs["ranks"]]
    assert "dist rank 0: watermark — dispatch resumes at batch 1 (32 overhang lines to skip)" \
        in errs[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_merged_equal_jax_one_process(runs, mode):
    want = _jax_one_process(runs["reads"], MODES[mode])
    assert _merged(merge_main, runs["modes"][mode]) == want
    assert len(want.splitlines()) == 300
