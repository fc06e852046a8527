"""The port's post-processing scripts against rkmh-tpu's, byte for byte.

Each module of ``rkmh_tpu_torch.scripts`` is a copy of its
``rkmh_tpu.scripts`` counterpart with its imports pointed at the port.  On
the cases of ``tests/test_scripts.py`` that need no reference data (plus a
few more: -M/-P/--format stream for vwize, LIN/SUB for interpret_wabbit,
--sample-file for make_mix, the shell-style quant), both ``main``s run on
the same input and must write the same bytes (stdout, stderr and the files
they write).  No tolerance: the outputs are text.
"""

import importlib
import io
import json
import os

import numpy as np
import pytest

from rkmh_tpu_torch.io.fastx import read_fastx


def _hpv_line(name, match, total, lin, sub, lin_counts, sub_counts):
    lins = "".join(f"{n}:{s};" for n, s in lin)
    subs = "".join(f"{n}:{s};" for n, s in sub)
    lc = "".join(f"{c};" for c in lin_counts)
    sc = "".join(f"{c};" for c in sub_counts)
    return f"{name}\ttypeX\t{match}/{total}\t{lins}\t{subs}\t{lc}\t{sc}\n"


def _score_real_input():
    lin = [("A", 0.02), ("B", 0.0), ("C", 0.0), ("D", 0.0)]
    sub = [("A1", 0.01), ("A2", 0.0), ("B1", 0.0)]
    lines = [_hpv_line(f"r{i}", 100, 2000, lin, sub, [20, 0, 0, 0], [9, 0, 0])
             for i in range(4)]
    lines.append(_hpv_line("short", 100, 30, lin, sub, [20, 0, 0, 0], [9, 0, 0]))
    lines.append(_hpv_line("weak", 5, 2000, lin, sub, [20, 0, 0, 0], [9, 0, 0]))
    lin = [("A", 0.02), ("B", 0.02), ("C", 0.0), ("D", 0.0)]
    lines.append(_hpv_line("amb", 100, 2000, lin, [("A1", 0.01), ("B1", 0.0)],
                           [20, 20, 0, 0], [9, 0]))
    lines.append(_hpv_line("mis", 100, 2000, [("D", 0.03), ("A", 0.0), ("B", 0.0), ("C", 0.0)],
                           [("A1", 0.02), ("D1", 0.01), ("B1", 0.0)], [30, 0, 0, 0],
                           [9, 8, 0]))
    return "".join(lines)


def _run_both(name, argv=None, stdin_text=None, kwargs=("stdout",)):
    """Run rkmh_tpu.scripts.<name>.main and the port's on the same input;
    -> (rkmh-tpu's outputs, the port's)."""
    results = []
    for pkg in ("rkmh_tpu", "rkmh_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.scripts.{name}")
        out, err = io.StringIO(), io.StringIO()
        kw = {"stdout": out, "stderr": err}
        call = {k: kw[k] for k in kwargs}
        if stdin_text is not None:
            call["stdin"] = io.StringIO(stdin_text)
        rc = mod.main(argv=argv, **call) if argv is not None else mod.main(**call)
        results.append((rc, out.getvalue(), err.getvalue()))
    return results


def test_score_real_classification():
    want, got = _run_both("score_real_classification", stdin_text=_score_real_input(),
                          kwargs=("stdout", "stderr"))
    assert got == want and "mistmatch" in got[2]


def test_score_test_data_and_crunch_score(tmp_path):
    p = tmp_path / "1000_A1_0-0.7_D3_0-0.3_500_.fq"
    lines = [f"r{i}\tT\t10/100\tA:0.02;B:0;C:0;D:0;\tA1:0.02;D3:0;\t1;\t1;\n" for i in range(70)]
    lines += [f"s{i}\tT\t10/100\tD:0.02;A:0;B:0;C:0;\tD3:0.02;A1:0;\t1;\t1;\n"
              for i in range(30)]
    p.write_text("".join(lines))
    want, got = _run_both("score_test_data", argv=[str(p)])
    assert got == want and got[1].startswith("True True False")
    s = tmp_path / "1000_A1_0-0.6_B2_0-0.4_200_.score"
    s.write_text("A1 0.55\nB2 0.45\nC1 0.0\n")
    want, got = _run_both("crunch_score", argv=[str(s)])
    assert got == want and got[1].splitlines()[0].startswith("A1 0.6 0.55")


def test_process_and_score_cls(tmp_path):
    cls = tmp_path / "x.cls"
    rows = [f"gi|1|A1_read{i}|x\tT\tA1:0.02;B1:0;\tA1:0.02;B1:0;\tA2:0.01;\n"
            for i in range(8)]
    rows.append("gi|1|rand_read|x\tT\tA1:0.02;\tA1:0.02;\tA1:0;\n")
    rows.append("gi|1|B1_read|x\tT\tB1:0.01;A1:0;\tB2:0.03;B1:0;\tC:0;\tD:0\n")
    cls.write_text("".join(rows))
    for extra in ([], ["--real-data"]):
        want, got = _run_both("process_cls", argv=[str(cls), *extra])
        assert got == want
    want, got = _run_both("process_cls", argv=[str(cls)])
    scored = _run_both("score_cls", stdin_text=want[1], kwargs=("stdout",))
    assert scored[1] == scored[0] and "A1 1.0 1.0" in scored[1][1]


@pytest.mark.parametrize("argv", [
    ["-C", "0", "-s", "A1", "B1"],
    ["-C", "0", "-s", "A1", "B1", "-n"],
    ["-C", "0", "-c"],
    ["-C", "1", "-M"],
    ["-C", "0", "-n", "--format", "stream", "-s", "A1", "A2", "B1"],
])
def test_vwize_and_collapse(tmp_path, argv):
    f = tmp_path / "A1_sample.cls"
    f.write_text("Sample: r\tResult: A1\ty\n" * 3 + "Sample: r\tResult: B1\ty\n" + "x\n")
    g = tmp_path / "A2_0-0.5_stream.rk"
    g.write_text("A2 synthetic\tread0\t40\t4000\t\t\nB1 x\tread1\t3\t4000\t\t\n\tread2\t0\t4000\t\t\n")
    path = str(g if "stream" in argv else f)
    want, got = _run_both("vwize", argv=["-i", path, *argv])
    assert got == want and got[1].count("|vir") == 1
    from rkmh_tpu.scripts.collapse_subtypes import collapse_line as jax_collapse
    from rkmh_tpu_torch.scripts.collapse_subtypes import collapse_line

    assert collapse_line(got[1]) == jax_collapse(want[1])
    want, got = _run_both("collapse_subtypes", stdin_text=want[1] * 2)
    assert got == want


def test_vwize_predict_map(tmp_path):
    f = tmp_path / "A1_single_0_.cls"
    f.write_text("Sample: r\tResult: A1\ty\n" * 2)
    m = tmp_path / "classes.tsv"
    m.write_text("A1\t1\nA2\t2\ncoinfected\t3\n")
    want, got = _run_both("vwize", argv=["-i", str(f), str(f), "-C", "0", "1", "-P", str(m)])
    assert got == want and got[1].splitlines()[1].startswith("3 1.0")


@pytest.mark.parametrize("flags", [["-c", "-k"], [], ["-k"]])
def test_json_to_wabbit(tmp_path, flags):
    f = tmp_path / "s.json"
    f.write_text(json.dumps([{"name": "a|b", "sketches": [11, 22, 22]},
                             {"name": "c", "sketches": {"hashes": [2**64 - 5, 7]}}]))
    want, got = _run_both("json_to_wabbit", argv=["-i", str(f), *flags])
    assert got == want


def test_conf_mat(tmp_path):
    f = tmp_path / "preds.txt"
    f.write_text("1.5 hpv\n-0.3 hpv\n-2.0 coinf\n0.7 coinf\n0.0 hpv\n")
    want, got = _run_both("conf_mat", argv=[str(f)])
    assert got == want and got[1].splitlines()[0] == "status correct"


@pytest.mark.parametrize("kind", ["BINARY", "LIN", "SUB"])
def test_interpret_wabbit(tmp_path, kind):
    f = tmp_path / "logits.txt"
    f.write_text("2.0 sampleA\n-1.0 sampleB\n0 sampleC\n5\n\n11 x\n")
    want, got = _run_both("interpret_wabbit", argv=["-i", str(f), "-T", kind])
    assert got == want


def _strain_files(tmp_path):
    for label in ("A1", "B1", "C1"):
        with open(tmp_path / f"{label}.fq", "w") as fh:
            for i in range(200):
                seq = "".join(np.random.default_rng(i).choice(list("ACGT"), 60))
                fh.write(f"@{label}_{i}\n{seq}\n+\n{'I' * 60}\n")


def _mixes(path):
    return {p.name: p.read_bytes() for p in sorted(path.glob("*_.fq"))}


@pytest.mark.parametrize("mode", ["random", "sample-file"])
def test_make_mix(tmp_path, monkeypatch, mode):
    from rkmh_tpu.scripts import make_mix as jax_mix
    from rkmh_tpu_torch.scripts import make_mix

    _strain_files(tmp_path)
    if mode == "random":
        table = tmp_path / "strains.tsv"
        table.write_text("".join(f"{s}\t{tmp_path}/{s}.fq\n" for s in ("A1", "B1", "C1")))
        argv = ["--random", str(table), "-n", "3", "-l", "500", "-m", "100"]
    else:
        blocks = tmp_path / "mixes.tsv"
        blocks.write_text(f"# a comment\nA1\t0.7\t300\t{tmp_path}/A1.fq\n"
                          f"B1\t0.3\t300\t{tmp_path}/B1.fq\n\n"
                          f"C1\t1.0\t200\t{tmp_path}/C1.fq\n")
        argv = ["--sample-file", str(blocks), "-l", "500"]
    written = []
    for mod, sub in ((jax_mix, "jax"), (make_mix, "port")):
        d = tmp_path / sub
        d.mkdir()
        monkeypatch.chdir(d)
        mod._PARSE_CACHE.clear()
        assert mod.main(argv=argv) == 0
        written.append(_mixes(d))
    assert written[0] == written[1] and len(written[0]) in (2, 3)
    first = next(iter(written[1]))
    assert read_fastx(os.path.join(tmp_path, "port", first))


@pytest.mark.parametrize("by_ref", [True, False])
def test_quant(by_ref):
    data = ("refA\tr1 gi|1|A1_x\t5\t1000\t\t\nrefA\tr2 gi|2|B1_y\t6\t1000\t\t\n"
            "refB\tr3\t1\t1000FAIL:DEPTH\t\t\nrefC\tr4 q|w|A1_z\t1\t1000\t\t\n")
    want, got = _run_both("quant", argv=["-", *(["--by-ref"] if by_ref else [])],
                          stdin_text=data)
    assert got == want


def test_each_script_is_a_copy_with_its_console_script():
    """Every rkmh_tpu script has a port module and an rkmh-tpu-torch-*
    console script pointing at it."""
    import tomllib

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = sorted(p[:-3] for p in os.listdir(os.path.join(repo, "rkmh_tpu", "scripts"))
                   if p.endswith(".py") and p != "__init__.py")
    assert len(names) == 12
    with open(os.path.join(repo, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    jax_targets = {v.split(":")[0].rsplit(".", 1)[1]: k for k, v in scripts.items()
                   if v.startswith("rkmh_tpu.scripts.")}
    for name in names:
        importlib.import_module(f"rkmh_tpu_torch.scripts.{name}")
        port_name = jax_targets[name].replace("rkmh-tpu-", "rkmh-tpu-torch-", 1)
        assert scripts[port_name] == f"rkmh_tpu_torch.scripts.{name}:main"
    assert scripts["rkmh-tpu-torch-wabbit"] == "rkmh_tpu_torch.ml.wabbit:main"
