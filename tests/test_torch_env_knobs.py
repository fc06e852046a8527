"""The environment variables rkmh-tpu reads, read the same way by the port.

* ``RKMH_TPU_CHUNK_READS``: the chunk size when ``--chunk-reads`` is 0;
  filter's ``FILE.progress`` sidecar, saved after each chunk, must equal
  rkmh-tpu's save by save under it.
* ``RKMH_TPU_FAIL_AFTER_CHUNKS=N``: ``stream``, ``filter`` and ``hpv16``
  ``-o`` runs stop after their N-th emitted chunk, and ``call -o`` after
  its N-th scanned reference, with rkmh-tpu's exception text and the same
  partial bytes (and sidecars); ``--resume`` from there, in either
  package, gives the uninterrupted bytes.  ``hash`` and ``search`` run to
  the end under it in both packages.
* ``RKMH_TPU_SET_TABLE_MAX_MB``: hpv16 takes the sorted-key panel past
  the cap (0), the bucket table under it (unset: 2,048 MB; 1,000,000), as
  rkmh-tpu does, with its log line.
* ``RKMH_TPU_SLOTS`` and ``RKMH_TPU_TABLE_BUDGET_MB``, read at import (in a
  subprocess each): the port's device set table and panel table equal
  rkmh-tpu's under them, at another width than without them, and a bad
  value raises rkmh-tpu's error text; the set-probe kernel's packing
  refuses a forced width past its 31 slots with the kernel's name.

Inputs are synthetic (rkmh_tpu_torch.synth, made from a seed); the port
runs its plain path on the CPU.  Tolerance: none.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rkmh_tpu.commands import call_cmd as jcall
from rkmh_tpu.commands import common as jcommon
from rkmh_tpu.commands import filter_cmd as jfilter
from rkmh_tpu.commands import hash_cmd as jhash
from rkmh_tpu.commands import hpv16_cmd as jhpv16
from rkmh_tpu.commands import recovery as jrecovery
from rkmh_tpu.commands import search_cmd as jsearch
from rkmh_tpu.commands import stream as jstream
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.ops import lookup
from rkmh_tpu_torch.ops.set_probe import pack_set_table
from rkmh_tpu_torch.commands import (
    call_cmd,
    common,
    filter_cmd,
    hash_cmd,
    hpv16_cmd,
    recovery,
    search_cmd,
    stream,
)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("env")
    refs, short, _, _ = synth.write_workload(str(d), 60, 150, num_refs=4, genome_len=1500,
                                             seed=13, n_rate=0.02)
    names, genomes = synth.make_panel(4, 1500, seed=13)
    reads, _ = synth.make_reads(genomes, 30, 300, seed=14)
    lens = np.random.default_rng(15).integers(0, 300, 30)
    lens[[0, 9]] = (0, 5)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(reads, lens)):
            fh.write(f">q{i}\n{r[:n].tobytes().decode()}\n")
    kmers = str(d / "kmers.txt")
    with open(kmers, "w") as fh:
        g = synth._ACGTN[genomes]
        fh.writelines(g[p % 4, p: p + 12].tobytes().decode() + "\n" for p in range(0, 1400, 9))
    hp = synth.write_hpv16_refpath(str(d / "hpv16"), seed=3, num_types=8, genome_len=1500)
    hp_reads, _ = synth.make_nanopore_reads(30, 5, hp, mean_len=900, min_len=900, max_len=900)
    synth.write_fastq_records(str(d / "hpv16.fq"), hp_reads)
    ref, call_reads, _, _ = synth.write_call_workload(str(d / "call"), n_reads=120, seed=5)
    seq = "".join(open(ref).read().split("\n")[1:])
    multi = str(d / "multi.fa")
    with open(multi, "w") as fh:
        fh.write(f">partA\n{seq[:2600]}\n>partB\n{seq[2500:5100]}\n>partC\n{seq[5000:]}\n")
    return {"refs": refs, "short": short, "mixed": mixed, "kmers": kmers,
            "hpv16": str(d / "hpv16"), "hpv16_reads": str(d / "hpv16.fq"),
            "call_reads": call_reads, "multi": multi}


def _config(command, pkg, data, **kw):
    """(run, config) of `command` in rkmh-tpu (pkg "jax") or the port."""
    port = pkg == "torch"
    extra = {"device": "cpu"} if port else {}
    if command == "stream":
        mod = stream if port else jstream
        return mod.run, mod.StreamConfig(ref_files=[data["refs"]], read_files=[
            data["short"], data["mixed"]], ks=(12,), batch_size=8, **kw, **extra)
    if command == "filter":
        mod = filter_cmd if port else jfilter
        return mod.run, mod.FilterConfig(ref_files=[data["refs"]], read_files=[
            data["short"], data["mixed"]], ks=(12,), min_matches=8, batch_size=8, **kw, **extra)
    if command == "hpv16":
        mod = hpv16_cmd if port else jhpv16
        return mod.run, mod.Hpv16Config(read_files=[data["hpv16_reads"]], refpath=data["hpv16"],
                                        ks=(16,), batch_size=8, **kw, **extra)
    if command == "hash":
        mod = hash_cmd if port else jhash
        return mod.run, mod.HashConfig(read_files=[data["mixed"], data["short"]], ks=(12,),
                                       batch_size=8, **kw, **extra)
    if command == "search":
        mod = search_cmd if port else jsearch
        return mod.run, mod.SearchConfig(ref_files=[data["kmers"]], read_files=[
            data["mixed"], data["short"]], ks=(12,), batch_size=8, **kw, **extra)
    mod = call_cmd if port else jcall
    kw.pop("chunk_reads", None)
    return mod.run, mod.CallConfig(ref_files=[data["multi"]], read_files=[data["call_reads"]],
                                   ks=(16,), **kw, **extra)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # hpv16 writes its .tst side file here
    return tmp_path


@pytest.mark.parametrize("env", ["3", "0", "-2", "x", "", None])
@pytest.mark.parametrize("requested", [0, 5])
def test_resolve_chunk_reads_reads_the_env_as_jax(monkeypatch, env, requested):
    if env is None:
        monkeypatch.delenv("RKMH_TPU_CHUNK_READS", raising=False)
    else:
        monkeypatch.setenv("RKMH_TPU_CHUNK_READS", env)
    got = common.resolve_chunk_reads(requested)
    assert got == jcommon.resolve_chunk_reads(requested)
    assert got == (requested or (3 if env == "3" else 65536))


def test_chunk_reads_env_sidecar_save_by_save_as_jax(data, in_tmp, monkeypatch):
    monkeypatch.setenv("RKMH_TPU_CHUNK_READS", "3")
    saves = {"jax": [], "torch": []}
    for name, cls in (("jax", jrecovery.Progress), ("torch", recovery.Progress)):
        def save(self, reads_done, output_bytes, _orig=cls.save, _log=saves[name]):
            _log.append((reads_done, output_bytes))
            _orig(self, reads_done, output_bytes)
        monkeypatch.setattr(cls, "save", save)
    outs = {}
    for pkg in ("jax", "torch"):
        out = str(in_tmp / f"{pkg}.fq")
        fn, cfg = _config("filter", pkg, data, out_file=out)
        assert fn(cfg) == 0
        outs[pkg] = (Path(out).read_bytes(), Path(out + ".progress").read_bytes())
    assert outs["torch"] == outs["jax"]
    assert saves["torch"] == saves["jax"] and len(saves["torch"]) == 20 + 10  # 3-read chunks


def _fail_run(command, pkg, data, out, monkeypatch):
    """An -o run under RKMH_TPU_FAIL_AFTER_CHUNKS=2 -> the exception text."""
    monkeypatch.setenv("RKMH_TPU_FAIL_AFTER_CHUNKS", "2")
    fn, cfg = _config(command, pkg, data, out_file=out, chunk_reads=11)
    failure = (jrecovery if pkg == "jax" else recovery).InjectedFailure
    with pytest.raises(failure) as exc:
        fn(cfg)
    monkeypatch.delenv("RKMH_TPU_FAIL_AFTER_CHUNKS")
    return str(exc.value)


def _sidecars(path):
    return [Path(p).read_bytes() if os.path.exists(p) else None
            for p in (path, path + ".progress")]


@pytest.mark.parametrize("command", ["stream", "filter", "hpv16", "call"])
def test_fail_after_chunks_stops_as_jax_and_resumes(data, in_tmp, monkeypatch, command):
    monkeypatch.delenv("RKMH_TPU_FAIL_AFTER_CHUNKS", raising=False)
    want = str(in_tmp / "want")
    fn, cfg = _config(command, "jax", data, out_file=want, chunk_reads=11)
    assert fn(cfg) == 0
    full = Path(want).read_bytes()
    parts = {}
    for pkg in ("jax", "torch"):
        part = str(in_tmp / pkg)
        msg = _fail_run(command, pkg, data, part, monkeypatch)
        parts[pkg] = (msg, *_sidecars(part))
    assert parts["torch"] == parts["jax"]
    msg, partial, _ = parts["torch"]
    if command == "call":
        assert msg == "injected failure after 2 refs" and partial is None  # the VCF comes last
    else:
        assert msg == "RKMH_TPU_FAIL_AFTER_CHUNKS=2 tripped"
        assert 0 < len(partial) < len(full) and full.startswith(partial)
    for maker, resumer in (("jax", "torch"), ("torch", "jax")):
        part = str(in_tmp / f"{maker}-{resumer}")
        for src, dst in zip((str(in_tmp / maker), str(in_tmp / maker) + ".progress"),
                            (part, part + ".progress")):
            if os.path.exists(src):
                shutil.copyfile(src, dst)
        fn, cfg = _config(command, resumer, data, out_file=part, chunk_reads=7, resume=True)
        assert fn(cfg) == 0
        assert Path(part).read_bytes() == full, f"{resumer} resuming {maker}'s output"


@pytest.mark.parametrize("command", ["hash", "search"])
def test_hash_and_search_run_to_the_end_under_fail_after(data, in_tmp, monkeypatch, command):
    outs = {}
    for env in (None, "1"):
        if env:
            monkeypatch.setenv("RKMH_TPU_FAIL_AFTER_CHUNKS", env)
        for pkg in ("jax", "torch"):
            out = str(in_tmp / f"{pkg}{env}")
            fn, cfg = _config(command, pkg, data, out_file=out, chunk_reads=11)
            assert fn(cfg) == 0
            outs[pkg, env] = Path(out).read_bytes()
    assert outs["torch", "1"] == outs["jax", "1"] == outs["jax", None] == outs["torch", None]
    assert outs["torch", "1"].count(b"\n") > 11


@pytest.mark.parametrize("cap", ["0", None, "1000000"])
def test_set_table_cap_picks_the_path_as_jax(data, in_tmp, monkeypatch, capsys, cap):
    if cap is None:
        monkeypatch.delenv("RKMH_TPU_SET_TABLE_MAX_MB", raising=False)
    else:
        monkeypatch.setenv("RKMH_TPU_SET_TABLE_MAX_MB", cap)
    cfg = dict(refpath=data["hpv16"], tst_file=False)
    jtb = jhpv16.build_tables(jhpv16.Hpv16Config(**cfg), (16,))
    want = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("hpv16 panel")]
    tb = hpv16_cmd.build_tables(hpv16_cmd.Hpv16Config(**cfg), (16,), torch.device("cpu"))
    got = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("hpv16 panel")]
    assert got == want
    assert (tb.comb_sorted is not None) == (jtb.comb_sorted is not None) == (cap == "0")
    assert (tb.comb_table is None) == (cap == "0")
    if cap == "0":
        keys, masks = jtb.comb_sorted
        assert np.array_equal(tb.comb_sorted.masks.numpy().view(np.uint32), np.asarray(masks))
        assert got == [f"hpv16 panel: projected bucket table exceeds RKMH_TPU_SET_TABLE_MAX_MB=0;"
                       f" using the sorted-key panel (0 MB)"]


_KNOB_SCRIPT = """
import numpy as np, torch
import rkmh_tpu, jax.numpy as jnp
try:
    from rkmh_tpu.ops import lookup as jl
except ValueError as e:
    want_err = str(e)
    try:
        from rkmh_tpu_torch.ops import lookup as tl
    except ValueError as e2:
        assert str(e2) == want_err, (str(e2), want_err)
        print("refused", want_err)
    raise SystemExit(0)
from rkmh_tpu_torch.ops import lookup as tl
rng = np.random.default_rng(4)
h = rng.integers(1, 2**64 - 1, size=(40, 300), dtype=np.uint64)
m = rng.random(h.shape) < 0.9
want = np.asarray(jl.build_set_table_device(jnp.asarray(h), jnp.asarray(m), 40))
got = tl.build_set_table_device(torch.from_numpy(h.view(np.int64)), torch.from_numpy(m), 40)
assert np.array_equal(got.numpy(), want.view(np.int32)), (tuple(got.shape), want.shape)
sk = np.sort(h[:, :200], axis=1)
lens = np.full(40, 200, np.int32)
want_p = np.asarray(jl.build_panel_table_device(jnp.asarray(sk), jnp.asarray(lens)))
got_p = tl.build_panel_table_device(torch.from_numpy(sk.view(np.int64)), torch.from_numpy(lens))
assert np.array_equal(got_p.numpy(), want_p.view(np.int32)), (tuple(got_p.shape), want_p.shape)
print("widths", got.shape[1], got_p.shape[1])
"""


def _knob_widths():
    """The set and panel table widths of _KNOB_SCRIPT's rows with no knob set."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.integers(1, 2**64 - 1, size=(40, 300), dtype=np.uint64).view(
        np.int64))
    m = torch.from_numpy(rng.random(tuple(h.shape)) < 0.9)
    sk = torch.from_numpy(np.sort(h.numpy().view(np.uint64)[:, :200], axis=1).view(np.int64))
    return (lookup.build_set_table_device(h, m, 40).shape[1],
            lookup.build_panel_table_device(sk, torch.full((40,), 200)).shape[1])


@pytest.mark.parametrize("env,value", [("RKMH_TPU_SLOTS", "6"), ("RKMH_TPU_TABLE_BUDGET_MB", "0"),
                                       ("RKMH_TPU_SLOTS", "0"), ("RKMH_TPU_SLOTS", "six")])
def test_table_knobs_read_at_import_as_jax(env, value):
    env_vars = {k: v for k, v in os.environ.items()
                if k not in ("RKMH_TPU_SLOTS", "RKMH_TPU_TABLE_BUDGET_MB")}
    proc = subprocess.run([sys.executable, "-c", _KNOB_SCRIPT], capture_output=True, text=True,
                          env={**env_vars, env: value, "JAX_PLATFORMS": "cpu"},
                          cwd=Path(__file__).resolve().parent.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    words = proc.stdout.split()
    if value in ("0", "six") and env == "RKMH_TPU_SLOTS":
        assert words[0] == "refused" and env in proc.stdout
        return
    assert words[0] == "widths"
    got = (int(words[1]), int(words[2]))
    assert got != _knob_widths()
    if env == "RKMH_TPU_SLOTS":  # 40 references: Wm = 2, a row of S * 5 lanes
        assert got == (30, 30)


def test_set_probe_packing_refuses_a_width_past_its_slots():
    h = torch.arange(1, 201, dtype=torch.int64).reshape(4, 50)
    table, _ = lookup.device_set_table(h, torch.ones(h.shape, dtype=torch.bool), 64, 4, slots=32)
    with pytest.raises(ValueError, match=r"set-probe kernel \(K3\).* at most 31 slots.* got 32"):
        pack_set_table(table, 4)
