"""`rkmh-tpu-torch call` and its scan against the JAX package.

Inputs are made from a seed with numpy: the 240 bp SNP fixture of
tests/test_call.py, a ~2 kb reference with runs of N and reads with N, and
``synth.write_call_workload`` (HPV16REF with planted substitutions and
deletions, nanopore-like reads of the sample; fewer reads than the
workload's 1,100, to keep the suite short).  The port runs its plain path
on the CPU; the JAX package runs on the CPU too.  Tolerance: none (integer
arrays and bytes must be equal).

* ``call_scan_plain`` (the port's ``call_scan_ref`` on a CPU tensor)
  against the JAX ``call_scan_ref``, array by array, at k in {1, 12, 16,
  31, 32, 33} and window lengths 1, 100 and more than P, the depth map
  carried over from the JAX map (``convert.hashmap_from_numpy``); the positional hashes split
  into overlapping rows equal the unsplit row;
* the command, byte for byte: the VCF, ``-d``, several references (the
  warning line), a reference shorter than k, no ``-k`` (the default-16
  line), two ``-k`` (exit 1), ``--resume`` from a ``.progress`` sidecar cut
  at a section boundary, inside a section and inside a line, and from the
  JAX package's own sidecar, ``--resume`` without ``-o`` (exit 1); the CLI,
  with ``--dist-*`` rejected by name;
* ``call --devices 4`` and ``--devices 8`` against rkmh-tpu's sharded run
  on JAX's 8 virtual CPU devices (the port on ``mesh_devices = (cpu,) *
  8``): the VCF, ``-d``, several references and ``--resume``, byte for
  byte; the two fallback lines (more devices than visible; a reference of
  fewer positions a slice than the window); the slices' pieces alone:
  ``_enumerate_plain`` with a base and ``window_average`` with a halo equal
  the unsharded result sliced, and ``ShardedCallScan`` equals the JAX
  ``sharded_call_scan_fn``'s arrays.
"""

import io
import os
import shutil

import numpy as np
import pytest
import torch

from rkmh_tpu import call_engine as jcall_engine
from rkmh_tpu import oracle
from rkmh_tpu.cli import build_parser as jax_parser
from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands.call_cmd import CallConfig as JaxConfig
from rkmh_tpu.commands.call_cmd import run as jax_run
from rkmh_tpu.io.packing import bucket_length
from rkmh_tpu.io.packing import encode_seqs as jax_encode
from rkmh_tpu.ops import hashmap as jhashmap
from rkmh_tpu_torch import call_engine, cli, convert, synth
from rkmh_tpu_torch.commands.call_cmd import CallConfig, run
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain
from rkmh_tpu_torch.ops.hashmap import depth_map_from_hashes

NAMES = ("depth", "avg", "site", "snp_depth", "snp_call", "max_rescue", "del_depth",
         "del_call")


def _mutate(seq: bytes, pos: int, base: bytes) -> bytes:
    return seq[:pos] + base + seq[pos + 1:]


@pytest.fixture(scope="module")
def snp240():
    """240 bp reference; most reads carry a SNP at 117 (tests/test_call.py)."""
    rng = np.random.default_rng(7)
    ref = bytes(rng.choice(list(b"ACGT"), size=240).tolist())
    snp = _mutate(ref, 117, b"T" if ref[117:118] != b"T" else b"C")
    reads = []
    for _ in range(8):
        s = int(rng.integers(0, len(ref) - 80))
        reads.append(ref[s:s + 80])
    for _ in range(80):
        s = int(rng.integers(0, len(snp) - 80))
        reads.append(snp[s:s + 80])
    return ref, reads


@pytest.fixture(scope="module")
def with_n():
    """~2 kb reference with runs of N and a planted SNP and deletion;
    150 bp reads of the sample, some with N bases."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 2000).astype(np.uint8)
    codes[300:320] = 4
    codes[1500:1503] = 4
    codes[999] = 4
    ref = synth._ACGTN[codes].tobytes()
    sample = bytearray(_mutate(ref, 700, b"A" if ref[700:701] != b"A" else b"G"))
    del sample[1200]
    sample = bytes(sample)
    reads = []
    for _ in range(150):
        s = int(rng.integers(0, len(sample) - 150))
        r = bytearray(sample[s:s + 150])
        for p in rng.integers(0, 150, 2):
            if rng.random() < 0.3:
                r[p] = ord("N")
        reads.append(bytes(r))
    return ref, reads


def _depth_map(reads, k):
    """The JAX map of every read k-mer (zeros included), from the port's
    plain window hashes."""
    codes, lens = encode_seqs(reads)
    h = kmer_window_hashes_plain(torch.from_numpy(codes), k).numpy()
    mask = np.arange(h.shape[1])[None, :] < (lens - (k - 1))[:, None]
    return jhashmap.depth_map_from_hashes(h.view(np.uint64), mask)


def _scan_both(ref: bytes, m, k: int, w: int):
    """(JAX call_scan_ref arrays cut to P, the port's on the CPU)."""
    codes, _ = jax_encode([ref], pad_to=bucket_length(len(ref)))
    P = len(ref) - k + 1
    want = {n: np.asarray(v)[:P] for n, v in
            jcall_engine.call_scan_ref(codes[0], m.device_arrays(), k, w).items()}
    table = convert.hashmap_from_numpy(m.hash_hi, m.hash_lo, m.used, m.values, "cpu")
    row = torch.from_numpy(encode_seqs([ref])[0][0, :len(ref)].copy())
    got = call_engine.call_scan_ref(row, table, k, w)
    return want, {n: v.numpy() for n, v in got.items()}


@pytest.mark.parametrize("k,w", [(12, 100), (16, 1), (33, 1000)])
def test_scan_matches_jax_on_the_snp_fixture(snp240, k, w):
    ref, reads = snp240
    d = oracle.read_depth_map(reads, k)
    keys = np.array(sorted(d), dtype=np.uint64)
    m = jhashmap.build_hash_map(keys, np.array([d[x] for x in keys.tolist()], np.int32))
    want, got = _scan_both(ref, m, k, w)
    for n in NAMES:
        assert got[n].shape == want[n].shape and got[n].dtype == want[n].dtype, n
        assert np.array_equal(got[n], want[n]), n
    if w == 100:
        assert got["snp_call"].any() and got["site"].any()
    if w == 1:  # a window of one position: avg == depth, no site
        assert not got["site"].any()


@pytest.mark.parametrize("k,w", [(16, 100), (12, 50)])
def test_scan_matches_jax_with_n_runs(with_n, k, w):
    ref, reads = with_n
    want, got = _scan_both(ref, _depth_map(reads, k), k, w)
    for n in NAMES:
        assert np.array_equal(got[n], want[n]), n
    P = len(ref) - k + 1
    assert (got["depth"][300 - k + 1:320] == got["depth"][300]).all()  # all read map[0]
    assert got["snp_call"].any() and got["del_call"].any() and got["site"].any()
    # an N origin's substitutions are never called
    n_origin = np.zeros((P, k), bool)
    for j in range(P):
        n_origin[j] = np.frombuffer(ref[j:j + k], np.uint8) == ord("N")
    assert not got["snp_call"][n_origin].any()


@pytest.mark.parametrize("k", [1, 12, 16, 31, 32, 33])
def test_scan_matches_jax_around_the_packed_route(with_n, k):
    """k = 1, and k on either side of K9's packed / byte-wise boundary (32),
    on the reference with N origins and runs of N and reads with N: every
    array of the JAX dict, exactly."""
    ref, reads = with_n
    want, got = _scan_both(ref, _depth_map(reads, k), k, 100)
    assert set(got) == set(want) == set(NAMES)
    for n in NAMES:
        assert got[n].shape == want[n].shape and got[n].dtype == want[n].dtype, n
        assert np.array_equal(got[n], want[n]), n
    assert got["site"].any()


@pytest.mark.parametrize("k,rows", [(16, 100), (16, 1985), (16, 1), (33, 64)])
def test_positional_hashes_split_rows_equal_the_whole_row(with_n, k, rows):
    ref, _ = with_n
    row = torch.from_numpy(encode_seqs([ref])[0][0, :len(ref)].copy())
    whole = kmer_window_hashes_plain(row[None], k)[0]
    split = call_engine.positional_hashes(row, k, row_windows=rows)
    assert split.shape == (len(ref) - k + 1,) and torch.equal(split, whole)


def test_scan_rejects_bad_input():
    with pytest.raises(ValueError, match="L >= k"):
        call_engine.call_scan_ref(torch.zeros(5, dtype=torch.uint8),
                                  depth_map_from_hashes(np.zeros(3, np.int64)), 16, 100)


# ---- the command ---------------------------------------------------------


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """HPV16REF with planted variants and 160 reads of the sample; a
    second reference file with three slices of it and a reference shorter
    than k."""
    d = tmp_path_factory.mktemp("call")
    ref, reads, truth, variants = synth.write_call_workload(str(d), n_reads=160, seed=5)
    seq = "".join(open(ref).read().split("\n")[1:])
    multi = str(d / "multi.fa")
    with open(multi, "w") as fh:
        fh.write(f">partA\n{seq[:2600]}\n>tiny\nACGTACGTAC\n>partB\n{seq[2500:5100]}\n"
                 f">partC\n{seq[5000:]}\n")
    return {"dir": d, "ref": ref, "reads": reads, "multi": multi, "variants": variants,
            "len": len(seq)}


def _both(capsys, **kw):
    """(JAX out, JAX stderr, port out, port stderr, JAX rc, port rc)."""
    capsys.readouterr()
    want = io.StringIO()
    jrc = jax_run(JaxConfig(**kw), out=want)
    werr = capsys.readouterr().err
    got = io.StringIO()
    rc = run(CallConfig(device="cpu", **kw), out=got)
    gerr = capsys.readouterr().err
    return want.getvalue(), werr, got.getvalue(), gerr, jrc, rc


def _logs(err: str):
    return [ln for ln in err.splitlines() if not ln.startswith(("E1", "W1", "I1"))]


def test_vcf_matches_jax_and_calls_the_planted_variants(workload, capsys):
    want, werr, got, gerr, jrc, rc = _both(capsys, ref_files=[workload["ref"]],
                                          read_files=[workload["reads"]])
    assert jrc == rc == 0 and got == want
    assert _logs(gerr) == _logs(werr) == [
        "No kmer size(s) provided. Will use a default kmer size of 16.", "Parsing sequences..."]
    body = [ln for ln in got.splitlines() if not ln.startswith("##")]
    assert got.startswith("##fileformat=VCF4.2\n##source=rkmh\n") and len(body) > 20
    keys = {"\t".join(ln.split("\t")[:5]) for ln in body}
    called = sum(f"HPV16REF\t{pos}\t.\t{r}\t{a}" in keys for pos, r, a, _ in workload["variants"])
    assert called >= 0.8 * len(workload["variants"])
    explicit = io.StringIO()
    assert run(CallConfig(ref_files=[workload["ref"]], read_files=[workload["reads"]],
                          ks=(16,), device="cpu"), out=explicit) == 0
    assert explicit.getvalue() == got


@pytest.mark.parametrize("kw", [
    dict(ks=(12,), show_depth=True),
    dict(ks=(16,), window_len=40),
    dict(ks=(16,), show_depth=True, window_len=1000),
], ids=["d-k12", "w40", "d-w1000"])
def test_command_matches_jax(workload, capsys, kw):
    want, werr, got, gerr, jrc, rc = _both(capsys, ref_files=[workload["ref"]],
                                          read_files=[workload["reads"]], **kw)
    assert jrc == rc == 0 and got == want and _logs(gerr) == _logs(werr)
    if kw.get("show_depth"):
        assert got.count("\n") == workload["len"] - kw["ks"][0] + 1


def test_several_references_and_one_shorter_than_k(workload, capsys):
    want, werr, got, gerr, jrc, rc = _both(capsys, ref_files=[workload["multi"]],
                                          read_files=[workload["reads"]], ks=(16,))
    assert jrc == rc == 0 and got == want
    assert "WARNING: more than one ref provided. VCF will not be correct" in _logs(gerr)
    assert _logs(gerr) == _logs(werr)
    names = {ln.split("\t")[0] for ln in got.splitlines() if not ln.startswith("##")}
    assert names == {"partA", "partB", "partC"}
    tiny = workload["dir"] / "tiny.fa"
    tiny.write_text(">tiny\nACGTACGTAC\n")
    want, _, got, _, jrc, rc = _both(capsys, ref_files=[str(tiny)],
                                     read_files=[workload["reads"]], ks=(16,))
    assert jrc == rc == 0 and got == want
    assert [ln for ln in got.splitlines() if not ln.startswith("##")] == []


def test_refusals_match_jax(workload, capsys):
    base = dict(ref_files=[workload["ref"]], read_files=[workload["reads"]])
    for kw, line in ((dict(ks=(12, 16)), "Only a single kmer size may be used for calling."),
                     (dict(ks=(16,), resume=True), "call --resume requires -o <file>"),
                     (dict(ks=(16,), ref_files=[]),
                      "call requires at least one reference and one read file.")):
        want, werr, got, gerr, jrc, rc = _both(capsys, **{**base, **kw})
        assert jrc == rc == 1 and got == want == "" and _logs(gerr) == _logs(werr), kw
        assert _logs(gerr)[0].startswith(line), kw


def _progress_cut(path: str, how: str) -> None:
    """Cut a .progress sidecar of four sections: after the first section's
    ref_done line, inside the second section, or inside a line of it."""
    lines = open(path, "rb").read().splitlines(keepends=True)
    done = [i for i, ln in enumerate(lines) if b"ref_done" in ln]
    assert len(done) == 3  # partA, partB, partC (tiny is shorter than k)
    if how == "boundary":
        keep = b"".join(lines[:done[0] + 1])
    elif how == "mid-section":
        keep = b"".join(lines[:done[0] + 1 + (done[1] - done[0]) // 2])
    else:
        cut = lines[:done[0] + 2]
        keep = b"".join(cut[:-1]) + cut[-1][: len(cut[-1]) // 2]
    with open(path, "wb") as fh:
        fh.write(keep)


@pytest.mark.parametrize("how", ["boundary", "mid-section", "torn-line", "jax-sidecar"])
def test_resume_equals_the_uninterrupted_vcf(workload, tmp_path, capsys, how):
    kw = dict(ref_files=[workload["multi"]], read_files=[workload["reads"]], ks=(16,))
    jax_out = str(tmp_path / "jax.vcf")
    assert jax_run(JaxConfig(out_file=jax_out, **kw)) == 0
    out = str(tmp_path / "port.vcf")
    assert run(CallConfig(out_file=out, device="cpu", **kw)) == 0
    full_vcf, full_progress = open(out).read(), open(out + ".progress").read()
    assert full_vcf == open(jax_out).read()
    assert full_progress == open(jax_out + ".progress").read()
    if how == "jax-sidecar":
        shutil.copyfile(jax_out + ".progress", out + ".progress")
        how = "mid-section"
    _progress_cut(out + ".progress", how)
    os.remove(out)
    capsys.readouterr()
    assert run(CallConfig(out_file=out, resume=True, device="cpu", **kw)) == 0
    assert "call --resume: 1 reference(s) already scanned" in capsys.readouterr().err
    assert open(out).read() == full_vcf
    # the sidecar is whole again, the sections in scan order
    assert open(out + ".progress").read() == full_progress


def test_cli_call_matches_jax(workload, tmp_path, capsys):
    argv = ["call", "-r", workload["ref"], "-f", workload["reads"], "-k", "16", "-w", "80",
            "-s", "500", "-t", "4"]
    assert jax_main([*argv, "-o", str(tmp_path / "jax.vcf")]) == 0
    assert cli.main([*argv, "-o", str(tmp_path / "port.vcf"), "--device", "cpu"]) == 0
    assert (tmp_path / "port.vcf").read_text() == (tmp_path / "jax.vcf").read_text()
    capsys.readouterr()
    assert cli.main([*argv, "-d", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_main([*argv, "-d"]) == 0
    assert capsys.readouterr().out == got and got.count("\n") == workload["len"] - 15


@pytest.mark.parametrize("argv", [
    ["call", "-r", "ref.fa", "-f", "a.fq"],
    ["call", "-r", "ref.fa", "-f", "a.fq", "-f", "b.fq", "-k", "21", "-s", "10", "-t", "4",
     "-w", "50", "-d", "-o", "out.vcf", "--resume"],
], ids=["defaults", "flags"])
def test_cli_parses_rkmh_tpu_flags_and_defaults(argv):
    want = vars(jax_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    assert set(got) - {"device"} == set(want)
    for key, value in want.items():  # --dist-* too, with rkmh-tpu's defaults
        assert got[key] == value, key
    assert got["device"] == "cuda"


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--dist-coordinator", "h:1"],
                                  ["--dist-procs", "2"], ["--dist-rank", "0"]])
def test_cli_rejects_flags_not_yet_ported(flag, workload, capsys):
    """--devices and --dist-* run since they were ported.  ``--devices 2
    --device cpu`` sees one device, logs rkmh-tpu's fallback line and
    prints rkmh-tpu's VCF; any --dist-* flag takes the --dist-* drain (as
    in rkmh-tpu, whatever the environment), which without -o refuses with
    rkmh-tpu's line before anything else (tests/test_torch_dist*.py run
    the groups)."""
    if flag[0] == "--devices":
        argv = ["call", "-r", workload["ref"], "-f", workload["reads"], "-k", "16", *flag]
        assert cli.main([*argv, "--device", "cpu"]) == 0
        got = capsys.readouterr()
        assert jax_run(JaxConfig(ref_files=[workload["ref"]], read_files=[workload["reads"]],
                                 ks=(16,))) == 0
        assert got.out == capsys.readouterr().out and got.out.startswith("##fileformat")
        assert ("call --devices ignored (--devices 2 > 1 visible device(s)); running "
                "single-device") in got.err.splitlines()
        return
    argv = ["call", "-r", "ref.fa", "-f", "reads.fq", *flag]
    assert jax_main(argv) == 1
    want = capsys.readouterr().err.splitlines()
    assert cli.main(argv) == 1
    assert capsys.readouterr().err.splitlines() == want == [
        "call --dist-* requires -o <file> (per-rank partials merge with rkmh-tpu-dist-merge)"]


def test_cli_call_on_cuda_without_a_gpu_fails(workload, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["call", "-r", workload["ref"], "-f", workload["reads"]])


# ---- --devices ---------------------------------------------------------------

GRID = (torch.device("cpu"),) * 8  # as many entries as JAX's virtual devices


@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("kw", [dict(), dict(show_depth=True), dict(multi=True)],
                         ids=["vcf", "d", "multi"])
def test_devices_match_jax(workload, capsys, devices, kw):
    refs = [workload["multi"] if kw.pop("multi", False) else workload["ref"]]
    base = dict(ref_files=refs, read_files=[workload["reads"]], ks=(16,), devices=devices, **kw)
    capsys.readouterr()
    want = io.StringIO()
    assert jax_run(JaxConfig(**base), out=want) == 0
    werr = capsys.readouterr().err
    got = io.StringIO()
    assert run(CallConfig(device="cpu", mesh_devices=GRID, **base), out=got) == 0
    assert got.getvalue() == want.getvalue() and _logs(capsys.readouterr().err) == _logs(werr)
    one = io.StringIO()
    assert run(CallConfig(device="cpu", **{**base, "devices": 0}), out=one) == 0
    assert one.getvalue() == got.getvalue()


def test_devices_resume_equals_the_uninterrupted_vcf(workload, tmp_path):
    kw = dict(ref_files=[workload["multi"]], read_files=[workload["reads"]], ks=(16,),
              devices=4)
    jax_out = str(tmp_path / "jax.vcf")
    assert jax_run(JaxConfig(out_file=jax_out, **kw)) == 0
    out = str(tmp_path / "port.vcf")
    shutil.copyfile(jax_out + ".progress", out + ".progress")
    _progress_cut(out + ".progress", "mid-section")
    assert run(CallConfig(out_file=out, resume=True, device="cpu", mesh_devices=GRID,
                          **kw)) == 0
    assert open(out).read() == open(jax_out).read()
    assert open(out + ".progress").read() == open(jax_out + ".progress").read()


@pytest.mark.parametrize("kw,line", [
    (dict(devices=9), "call --devices ignored (--devices 9 > 8 visible device(s)); "
                      "running single-device"),
    (dict(devices=8, window_len=400, multi=True),
     "call --devices: partA spans only 2585 positions (< window 400 per device); "
     "single-device"),
], ids=["visible", "short"])
def test_devices_fallback_lines_match_jax(workload, capsys, kw, line):
    refs = [workload["multi"] if kw.pop("multi", False) else workload["ref"]]
    base = dict(ref_files=refs, read_files=[workload["reads"]], ks=(16,), **kw)
    capsys.readouterr()
    want = io.StringIO()
    assert jax_run(JaxConfig(**base), out=want) == 0
    werr = _logs(capsys.readouterr().err)
    got = io.StringIO()
    assert run(CallConfig(device="cpu", mesh_devices=GRID, **base), out=got) == 0
    gerr = _logs(capsys.readouterr().err)
    assert got.getvalue() == want.getvalue() and gerr == werr and line in gerr


@pytest.mark.parametrize("k,w,n", [(16, 100, 4), (12, 37, 8), (33, 1, 3)])
def test_slices_equal_the_unsharded_scan(with_n, k, w, n):
    """Each slice's pieces on their own: the window average with the
    previous slice's last w depths as its halo, ``_enumerate_plain`` at the
    slice's base (its deletions guarded on the global index), and the
    whole ``call_scan_slice``, against the unsharded arrays sliced; then
    ``ShardedCallScan`` against the JAX ``sharded_call_scan_fn``."""
    ref, reads = with_n
    m = _depth_map(reads, k)
    table = convert.hashmap_from_numpy(m.hash_hi, m.hash_lo, m.used, m.values, "cpu")
    row = torch.from_numpy(encode_seqs([ref])[0][0, :len(ref)].copy())
    whole = call_engine.call_scan_ref(row, table, k, w)
    P = len(ref) - k + 1
    Pl = -(-P // n)
    padded = torch.full((n * Pl + k + 1,), 255, dtype=torch.uint8)
    padded[0] = 4
    padded[1: 1 + len(ref)] = row
    get = call_engine.plain_getter(table)
    for d in range(n):
        j0, j1 = d * Pl, min((d + 1) * Pl, P)
        halo = whole["depth"][j0 - w: j0] if d else None
        avg, site = call_engine.window_average(whole["depth"][j0:j1], w, halo, base=j0)
        assert torch.equal(avg, whole["avg"][j0:j1]) and torch.equal(site, whole["site"][j0:j1])
        got = call_engine._enumerate_plain(row[j0:], get, k, whole["depth"][j0:j1], avg, site,
                                           0, j1 - j0, base=j0, lead=int(padded[j0]))
        for name, v in zip(NAMES[3:], got):
            assert torch.equal(v, whole[name][j0:j1]), (d, name)
        res = call_engine.call_scan_slice(padded[j0: j0 + Pl + k + 1], table, k, w, Pl, j0, halo)
        for name in NAMES:
            assert torch.equal(res[name][: j1 - j0], whole[name][j0:j1]), (d, name)
    if n > 1:  # position 0 is a pad deletion site only in slice 0
        assert not whole["del_call"][0].any()

    import jax

    from rkmh_tpu.parallel.mesh import make_mesh as jax_mesh, sharded_call_scan_fn
    from rkmh_tpu_torch.parallel.mesh import ShardedCallScan, make_mesh

    jm = jax_mesh(jax.devices()[:n], dp=n, tp=1)
    codes, _ = jax_encode([ref], pad_to=n * Pl + k)
    jpadded = np.concatenate([np.full(1, 4, np.uint8), codes[0]])
    slices = np.stack([jpadded[d * Pl: d * Pl + Pl + k + 1] for d in range(n)])
    want = {name: np.asarray(v)[:P] for name, v in
            sharded_call_scan_fn(jm, k, w)(slices, m.device_arrays()).items()}
    got = ShardedCallScan(make_mesh(GRID[:n], dp=n, tp=1), table, k, w)(row.numpy())
    for name in NAMES:
        assert np.array_equal(got[name], want[name]), name
