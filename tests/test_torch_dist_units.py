"""The --dist-* drains' parts against rkmh-tpu's, in one process.

``commands/dist_stream.py`` and ``parallel/distributed.py`` of the port
against ``rkmh_tpu/commands/dist_stream.py`` and
``rkmh_tpu/parallel/distributed.py``: the owned rows and resume watermark
(with the cases of ``tests/test_distributed.py:740-756`` and, for several
ranks, both packages' collective replaced by the same minimum), the read
shards, the ``.dist.json`` bytes, the --resume geometry guards, the idx
truncation, the -M checkpoint's fingerprint, the refusals' log lines
(before the group comes up, and after it for one process on 8 CPU devices:
rkmh-tpu's virtual devices, the port's ``mesh_devices``), and the merge
tool (both packages' ``merge_main`` on the same stripe files).  No process
group is started here.  Tolerance: none.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from rkmh_tpu.commands import call_cmd as jax_call_cmd
from rkmh_tpu.commands import count_cmd as jax_count_cmd
from rkmh_tpu.commands import dist_stream as jax_ds
from rkmh_tpu.commands import hash_cmd as jax_hash_cmd
from rkmh_tpu.commands import hpv16_cmd as jax_hpv16_cmd
from rkmh_tpu.commands import search_cmd as jax_search_cmd
from rkmh_tpu.commands.filter_cmd import FilterConfig as JaxFilterConfig
from rkmh_tpu.commands.stream import StreamConfig as JaxStreamConfig
from rkmh_tpu.parallel import distributed as jax_distributed
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.call_engine import plain_getter, positional_depths
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands import call_cmd, count_cmd, hash_cmd, hpv16_cmd, search_cmd
from rkmh_tpu_torch.commands import dist_stream as ds
from rkmh_tpu_torch.commands.filter_cmd import FilterConfig
from rkmh_tpu_torch.commands.stream import StreamConfig
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.parallel import distributed
from rkmh_tpu_torch.parallel.mesh import ShardedCallScan, make_mesh

CPU8 = (torch.device("cpu"),) * 8


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("units"))
    refs, reads, _, _ = synth.write_workload(d, 40, num_refs=12)
    return {"dir": d, "refs": refs, "reads": reads}


def test_owned_rows_equal_jax():
    for N in (0, 1, 10, 64, 65, 300):
        for B, H in ((8, 1), (8, 2), (12, 3), (64, 2), (64, 4)):
            Bl = B // H
            for rank in range(H):
                for b in range(-(-N // B) + 1):
                    assert ds._owned_block(b, B, Bl, rank) == jax_ds._owned_block(b, B, Bl, rank)
                    assert (ds._owned_lines(b, B, Bl, rank, N)
                            == jax_ds._owned_lines(b, B, Bl, rank, N))


def test_resume_watermark_cases():
    """tests/test_distributed.py:740-756, on the port."""
    assert [ds._owned_lines(b, 8, 4, 1, 10) for b in (0, 1)] == [4, 0]
    assert ds._resume_watermark(0, 10, 8, 4, 1, H=1) == (0, 0)
    assert ds._resume_watermark(2, 10, 8, 4, 1, H=1) == (0, 2)
    assert ds._resume_watermark(4, 10, 8, 4, 1, H=1) == (2, 0)
    assert [ds._owned_lines(b, 8, 4, 0, 10) for b in (0, 1)] == [4, 2]
    assert ds._resume_watermark(5, 10, 8, 4, 0, H=1) == (1, 1)
    assert ds._resume_watermark(6, 10, 8, 4, 0, H=1) == (2, 0)


@pytest.mark.parametrize("peer_batches", [0, 1, 3, 99])
def test_resume_watermark_equal_jax(monkeypatch, peer_batches):
    """Every rank's line count against rkmh-tpu's arithmetic, with the
    other ranks' complete batches standing in for the collective."""
    for mod in (ds, jax_ds):
        monkeypatch.setattr(mod, "_allmin", lambda v, H: min(int(v), peer_batches))
    for N, B, H in ((10, 8, 1), (300, 64, 2), (300, 128, 2), (301, 12, 3)):
        Bl = B // H
        for rank in range(H):
            total = sum(ds._owned_lines(b, B, Bl, rank, N) for b in range(-(-N // B)))
            for skip in range(total + 1):
                assert (ds._resume_watermark(skip, N, B, Bl, rank, H)
                        == jax_ds._resume_watermark(skip, N, B, Bl, rank, H))


def test_host_read_shard_equal_jax():
    for n_proc in (1, 2, 3, 7, 8):
        for n_rec in (0, 1, 5, 100, 1001):
            for p in range(n_proc):
                assert (distributed.host_read_shard(n_rec, p, n_proc)
                        == jax_distributed.host_read_shard(n_rec, p, n_proc))
    assert distributed.host_read_shard(7) == (0, 7)  # one process without a group


def test_initialize_one_process_is_a_noop(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(None, 1, 0) is False
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.allmin(5) == 5 and distributed.allmax(5) == 5
    assert not distributed.requested(1, "")
    assert distributed.requested(2, "") and distributed.requested(0, "h:1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert distributed.requested(0, "")


@pytest.mark.parametrize("args,env,message", [
    ((None, 2, 0), {}, "--dist-procs 2 needs --dist-coordinator host:port "
                       "(or JAX_COORDINATOR_ADDRESS)"),
    (("127.0.0.1:1", None, None), {}, "--dist-coordinator 127.0.0.1:1 needs --dist-procs "
                                      "(or JAX_NUM_PROCESSES)"),
    (("127.0.0.1:1", 2, None), {}, "--dist-procs 2 needs --dist-rank (or JAX_PROCESS_ID)"),
    (("127.0.0.1:1", 2, 2), {}, "--dist-rank 2 is not in [0, 2)"),
    ((None, None, None), {"JAX_NUM_PROCESSES": "3", "JAX_PROCESS_ID": "1"},
     "--dist-procs 3 needs --dist-coordinator host:port (or JAX_COORDINATOR_ADDRESS)"),
])
def test_initialize_refuses_settings_that_name_no_group(monkeypatch, args, env, message):
    """These refusals come before any socket is opened."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as exc:
        distributed.initialize(*args)
    assert str(exc.value) == message


def test_meta_sidecar_bytes_equal_jax(tmp_path):
    for B, H, fmt in ((64, 2, "stream"), (16384, 4, "filter"), (8, 1, "search")):
        a, b = str(tmp_path / "port"), str(tmp_path / "jax")
        ds._write_meta(a, B, H, fmt)
        jax_ds._write_meta(b, B, H, fmt)
        assert open(a + ".dist.json", "rb").read() == open(b + ".dist.json", "rb").read()
        assert ds._load_meta(a) == jax_ds._load_meta(a) == {"global_batch": B, "procs": H,
                                                             "format": fmt}
    with open(tmp_path / "torn.dist.json", "w") as fh:
        fh.write('{"global_ba')
    assert ds._load_meta(str(tmp_path / "torn")) is None


def test_resume_geometry_guards_equal_jax(tmp_path):
    out = str(tmp_path / "out.rk")
    cfg, jcfg = StreamConfig(out_file=out), JaxStreamConfig(out_file=out)
    errors = []
    for check, c in ((ds._check_resume_geometry, cfg), (jax_ds._check_resume_geometry, jcfg)):
        check(c, 64, 2, False)  # no stripe, no sidecar: a fresh start
        with pytest.raises(RuntimeError) as exc:
            check(c, 64, 2, True)
        got = [str(exc.value)]
        ds._write_meta(out, 64, 2)
        check(c, 64, 2, True)
        for B, H in ((128, 2), (64, 4)):
            with pytest.raises(RuntimeError) as exc:
                check(c, B, H, True)
            got.append(str(exc.value))
        os.remove(out + ".dist.json")
        errors.append(got)
    assert errors[0] == errors[1] and "missing or unreadable" in errors[0][0]
    assert "geometry mismatch" in errors[0][1]


def test_truncate_to_lines_equal_jax(tmp_path):
    text = b"a\nbb\nccc\ndddd"
    for n in (0, 1, 3, 4, 9):
        kept = []
        for fn, name in ((ds._truncate_to_lines, "p"), (jax_ds._truncate_to_lines, "j")):
            path = str(tmp_path / name)
            with open(path, "wb") as fh:
                fh.write(text)
            kept.append((fn(path, n), open(path, "rb").read()))
        assert kept[0] == kept[1]


def test_counter_fingerprint_equal_jax(workload):
    files = [workload["reads"], workload["refs"]]
    for args in (((12,), 100_000, 4, 2, 1), ((12, 16), 2 * 10**8, 2, 2, 0)):
        assert ds._counter_fingerprint(files, *args) == jax_ds._counter_fingerprint(files,
                                                                                     *args)
    assert ds._counter_fingerprint([workload["dir"] + "/none.fq"], (12,), 8, 1, 1, 0) == ""


def _both_refuse(capsys, port_run, port_cfg, jax_run, jax_cfg) -> str:
    assert jax_run(jax_cfg) == 1
    want = capsys.readouterr().err.splitlines()
    assert port_run(port_cfg) == 1
    got = capsys.readouterr().err.splitlines()
    assert got == want and len(got) == 1
    return got[0]


@pytest.mark.parametrize("cmd", ["stream", "filter"])
@pytest.mark.parametrize("case", ["stdin", "resume-no-o", "not-rereadable"])
def test_refusals_before_the_group_equal_jax(workload, capsys, cmd, case):
    kw = dict(ref_files=[workload["refs"]], read_files=[workload["reads"]], ks=(12,))
    if case == "stdin":
        kw["in_stream"] = True
    elif case == "resume-no-o":
        kw["resume"] = True
    else:
        kw["read_files"] = [workload["reads"], "-"]
    if cmd == "stream":
        line = _both_refuse(capsys, ds.run_distributed, StreamConfig(device="cpu", **kw),
                            jax_ds.run_distributed, JaxStreamConfig(**kw))
    else:
        line = _both_refuse(capsys, ds.run_distributed_filter, FilterConfig(device="cpu", **kw),
                            jax_ds.run_distributed_filter, JaxFilterConfig(**kw))
    assert line.startswith(f"{cmd} --dist-*")


@pytest.mark.parametrize("case,kw", [
    ("tp-local-devices", dict(tp=3)),
    ("counter-dp", dict(tp=2, min_kmer_occ=2, counter_size=100_001)),
    ("tp-references", dict(tp=8)),
])
def test_refusals_after_the_group_equal_jax(workload, capsys, case, kw):
    """One process over 8 devices (no group: rkmh-tpu's and the port's
    initialize are no-ops without a coordinator)."""
    kw = dict(ref_files=[workload["refs"]], read_files=[workload["reads"]], ks=(12,),
              sketch_size=200, **kw)
    line = _both_refuse(capsys, ds.run_distributed,
                        StreamConfig(device="cpu", mesh_devices=CPU8, **kw),
                        jax_ds.run_distributed, JaxStreamConfig(**kw))
    assert line.startswith("stream --dist-*: ")


def _stripes(tmp_path, name, lines_per_rank, idx=None, meta=None) -> list:
    paths = []
    for r, lines in enumerate(lines_per_rank):
        p = str(tmp_path / f"{name}.{r}")
        with open(p, "w") as fh:
            fh.write("".join(f"r{r} line {i}\n" for i in range(lines)))
        if idx is not None:
            with open(p + ".idx", "w") as fh:
                fh.write("".join(f"{c}\n" for c in idx[r]))
        paths.append(p)
    if meta is not None:
        with open(str(tmp_path / f"{name}.dist.json"), "w") as fh:
            json.dump(meta, fh)
    return paths


def _merge_both(argv):
    """Both merge tools' (exit code, stdout) on the same arguments."""
    got = []
    for main in (ds.merge_main, jax_ds.merge_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            try:
                rc = main(list(argv))
            except SystemExit as e:
                rc = e.code
        got.append((rc, buf.getvalue()))
    return got


@pytest.mark.parametrize("case", ["stream", "stream-3-ranks", "b-override", "filter",
                                  "search", "filter-lost-sidecar", "procs-mismatch",
                                  "no-sidecar"])
def test_merge_tool_equal_jax(tmp_path, case):
    if case == "stream":
        files = _stripes(tmp_path, "s", [160, 140], meta={"global_batch": 64, "procs": 2,
                                                         "format": "stream"})
    elif case == "stream-3-ranks":
        files = _stripes(tmp_path, "s", [10, 10, 7], meta={"global_batch": 12, "procs": 3,
                                                          "format": "stream"})
    elif case == "b-override":
        files = ["-b", "8", *_stripes(tmp_path, "s", [9, 5], meta={"global_batch": 64,
                                                                  "procs": 5,
                                                                  "format": "stream"})]
    elif case in ("filter", "filter-lost-sidecar"):
        meta = None if case.endswith("sidecar") else {"global_batch": 8, "procs": 2,
                                                      "format": "filter"}
        files = _stripes(tmp_path, "f", [12, 8], idx=[[1, 0, 2], [0, 2, 0]], meta=meta)
    elif case == "search":
        files = _stripes(tmp_path, "q", [3, 2], idx=[[1, 0, 2], [0, 2, 0]],
                         meta={"global_batch": 8, "procs": 2, "format": "search"})
    elif case == "procs-mismatch":
        files = _stripes(tmp_path, "s", [4, 4], meta={"global_batch": 8, "procs": 3,
                                                     "format": "stream"})
    else:
        files = _stripes(tmp_path, "s", [4, 4])
    port, jax = _merge_both(files)
    assert port == jax
    assert (port[0] == 0) == (case not in ("procs-mismatch", "no-sidecar"))
    if port[0] == 0:
        assert port[1]


def test_merge_refuses_idx_files_that_disagree(tmp_path):
    files = _stripes(tmp_path, "f", [12, 24], idx=[[1, 2], [1, 2, 3]])
    with pytest.raises(RuntimeError, match="ended early"):
        ds.merge_outputs_filter(files, out=io.StringIO())


def test_counter_checkpoint_round_trip(tmp_path, workload):
    """One process: the checkpoint holds the whole table (H = 1), loads
    back under its fingerprint only, and rkmh-tpu's loader reads its fields."""
    out = str(tmp_path / "o")
    table = np.arange(24, dtype=np.int32)
    fp = ds._counter_fingerprint([workload["reads"]], (12,), 24, 2, 1, 0)
    ds._save_counter_ckpt(table, out, fp, 1, 0)
    np.testing.assert_array_equal(ds._load_counter_ckpt(out, fp, 24, 1, 0), table)
    assert ds._load_counter_ckpt(out, fp + " ", 24, 1, 0) is None
    assert ds._load_counter_ckpt(out, fp, 48, 1, 0) is None
    with np.load(ds._counter_ckpt_path(out, 0)) as z:
        assert bytes(z["fp"]).decode() == fp and z["rows"].dtype == np.int32


# ---- hash, count, search, hpv16 and call (ROADMAP item 4: 9b, 9c)


def _map_cfgs(workload, cmd, **kw):
    """The port's and rkmh-tpu's config of a hash / count / search drain."""
    reads = [workload["reads"]]
    if cmd == "hash":
        return (hash_cmd.HashConfig(read_files=reads, ks=(12,), device="cpu", **kw),
                jax_hash_cmd.HashConfig(read_files=reads, ks=(12,), **kw))
    if cmd == "count":
        return (count_cmd.CountConfig(read_files=reads, ks=(12,), device="cpu", **kw),
                jax_count_cmd.CountConfig(read_files=reads, ks=(12,), **kw))
    refs = [workload["refs"]]
    return (search_cmd.SearchConfig(ref_files=refs, read_files=reads, ks=(12,), device="cpu",
                                    **kw),
            jax_search_cmd.SearchConfig(ref_files=refs, read_files=reads, ks=(12,), **kw))


def _hpv16_cfgs(data, **kw):
    kw = dict(read_files=[data["reads"]], refpath=data["refs"], ks=(16,), batch_size=8, **kw)
    return hpv16_cmd.Hpv16Config(device="cpu", **kw), jax_hpv16_cmd.Hpv16Config(**kw)


def _call_cfgs(data, **kw):
    kw = dict(ref_files=[data["ref"]], read_files=[data["reads"]], **kw)
    return call_cmd.CallConfig(device="cpu", **kw), jax_call_cmd.CallConfig(**kw)


@pytest.fixture(scope="module")
def hpv16_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("units_hpv16"))
    panel = synth.write_hpv16_refpath(d + "/refs", seed=3, num_types=12, genome_len=2000)
    reads, _ = synth.make_nanopore_reads(24, 5, panel, mean_len=1200, min_len=300,
                                         max_len=3000, n_rate=0.01)
    synth.write_fastq_records(d + "/reads.fq", reads)
    return {"dir": d, "refs": d + "/refs", "reads": d + "/reads.fq"}


@pytest.fixture(scope="module")
def call_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("units_call"))
    ref, reads, _, _ = synth.write_call_workload(d, n_reads=120)
    return {"dir": d, "ref": ref, "reads": reads}


BEFORE_GROUP = [  # (command, case): refused before the group comes up
    ("hash", "-K"), ("hash", "--json"), ("hash", "--sourmash"), ("hash", "-o"),
    ("hash", "not-rereadable"), ("count", "not-rereadable"), ("search", "not-rereadable"),
    ("hpv16", "resume-no-o"), ("hpv16", "not-rereadable"),
    ("call", "-d"), ("call", "no-o"), ("call", "not-rereadable"), ("call", "two-ks"),
]


@pytest.mark.parametrize("cmd,case", BEFORE_GROUP)
def test_new_refusals_before_the_group_equal_jax(workload, hpv16_data, call_data, capsys,
                                                 cmd, case):
    """Each line equals rkmh-tpu's, and no group, file or device work
    comes before it."""
    kw = {}
    if case == "-K":
        kw["output_kmers"] = True
    elif case == "--json":
        kw["json_out"] = True
    elif case == "--sourmash":
        kw["sourmash_out"] = True
    elif case == "-o":
        kw["out_prefix"] = workload["dir"] + "/prefix"
    elif case == "resume-no-o":
        kw["resume"] = True
    elif case == "-d":
        kw.update(show_depth=True, out_file=call_data["dir"] + "/v")
    elif case == "two-ks":
        kw.update(ks=(16, 18), out_file=call_data["dir"] + "/v")
    if cmd in ("hash", "count", "search"):
        port, jax = _map_cfgs(workload, cmd, **kw)
    elif cmd == "hpv16":
        port, jax = _hpv16_cfgs(hpv16_data, **kw)
    else:
        port, jax = _call_cfgs(call_data, **kw)
    if case == "not-rereadable":
        port.read_files = jax.read_files = [port.read_files[0], "-"]
        if cmd == "call":
            port.out_file = jax.out_file = call_data["dir"] + "/v"
    run = {"hash": "run_distributed_hash", "count": "run_distributed_count",
           "search": "run_distributed_search", "hpv16": "run_distributed_hpv16",
           "call": "run_distributed_call"}[cmd]
    line = _both_refuse(capsys, getattr(ds, run), port, getattr(jax_ds, run), jax)
    assert line.startswith(f"{cmd} --dist-*" if case != "two-ks" else "Only a single kmer")


@pytest.mark.parametrize("case", ["count-dp", "hpv16-tp", "hpv16-counter-dp"])
def test_new_refusals_after_the_group_equal_jax(workload, hpv16_data, capsys, case):
    """One process over 8 devices: rkmh-tpu's log, every line of it, up to
    and with the refusal."""
    if case == "count-dp":
        port, jax = _map_cfgs(workload, "count", counter_size=100_001, batch_size=64)
        port.mesh_devices = CPU8
        fns = ds.run_distributed_count, jax_ds.run_distributed_count
    else:
        kw = dict(tp=3) if case == "hpv16-tp" else dict(tp=2, min_kmer_occ=2,
                                                         counter_size=4097)
        port, jax = _hpv16_cfgs(hpv16_data, **kw)
        port.mesh_devices = CPU8
        fns = ds.run_distributed_hpv16, jax_ds.run_distributed_hpv16
    assert fns[1](jax) == 1
    want = capsys.readouterr().err.splitlines()
    assert fns[0](port) == 1
    got = capsys.readouterr().err.splitlines()
    assert got == want
    assert got[-1].startswith(f"{case.split('-')[0]} --dist-*: ")
    assert ("divisible" in got[-1]) == (case != "hpv16-tp")


def _sections(path, sections):
    with open(path, "w") as fh:
        for name, entries in sections:
            for key, c in entries:
                fh.write(json.dumps({"key": key, "c": c, "m": c + 1, "a": 7, "o": 2}) + "\n")
            fh.write(json.dumps({"ref_done": name, "n": len(entries)}) + "\n")
    return str(path)


@pytest.mark.parametrize("case", ["refs-total", "disagree", "all-short", "complete"])
def test_call_merge_refuses_incomplete_stripes_as_jax(tmp_path, case):
    """``tests/test_distributed.py:480``'s cases on both packages' merge."""
    full = _sections(tmp_path / "c.0", [("r1", [("r1\t5\t.\tA\tC", 1)]), ("r2", [])])
    short = _sections(tmp_path / "c.1", [("r1", [("r1\t9\t.\tG\t-", 2)])])
    files, total, match = {"refs-total": ([full, short], 2, "ended early"),
                           "disagree": ([full, short], None, "disagree"),
                           "all-short": ([short, short], 2, "ended early"),
                           "complete": ([full, full], 2, None)}[case]
    got = []
    for merge in (ds.merge_outputs_call, jax_ds.merge_outputs_call):
        buf = io.StringIO()
        if match is None:
            assert merge(files, "ref.fa", out=buf, refs_total=total) == 0
        else:
            with pytest.raises(RuntimeError, match=match) as exc:
                merge(files, "ref.fa", out=buf, refs_total=total)
            buf.write(str(exc.value))
        got.append(buf.getvalue())
    assert got[0] == got[1]


def test_merge_tool_call_stripes_equal_jax(tmp_path):
    files = [_sections(tmp_path / "v.0", [("r1", [("r1\t5\t.\tA\tC", 1),
                                                  ("r1\t10\t.\tT\t-", 1)])]),
             _sections(tmp_path / "v.1", [("r1", [("r1\t5\t.\tA\tC", 2),
                                                  ("r1\t7\t.\tG\tA", 3)])])]
    with open(tmp_path / "v.dist.json", "w") as fh:
        json.dump({"global_batch": 0, "procs": 2, "format": "call", "reference": "ref.fa",
                   "devices": 8, "refs_total": 1}, fh)
    port, jax = _merge_both(files)
    assert port == jax and port[0] == 0
    assert port[1].startswith("##fileformat=VCF4.2\n") and "KC=3;MD=3" in port[1]


def test_hpv16_rank_width_gives_full_width_bytes(hpv16_data, monkeypatch, tmp_path):
    """A rank (one process, 4 CPU entries at tp 2, -M 2) cuts its sorted
    rows at its own rows' window count; at rkmh-tpu's full width
    (``W_full``, :974) the lines are the same bytes."""
    widths = []
    real = engine.hpv16_compact_width

    def recorded(lens, L, ks):
        widths.append((real(lens, L, ks), sum(max(L - k + 1, 0) for k in ks)))
        return widths[-1][0]

    outs = []
    for fn in (recorded, lambda lens, L, ks: sum(max(L - k + 1, 0) for k in ks)):
        monkeypatch.setattr(engine, "hpv16_compact_width", fn)
        monkeypatch.chdir(tmp_path)
        port, _ = _hpv16_cfgs(hpv16_data, tp=2, min_kmer_occ=2, counter_size=4096)
        port.mesh_devices = (torch.device("cpu"),) * 4
        buf = io.StringIO()
        assert ds.run_distributed_hpv16(port, out=buf) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 24
    assert any(wc < full for wc, full in widths)


def test_call_local_halo_equals_carried_halo(call_data):
    """A rank's first slice (here 2 of 4) takes its halo from the whole map:
    the depths of the w positions before it equal those the scan over all
    4 slices carries from slice 1, and so do the slices' results."""
    cpu = torch.device("cpu")
    reads = call_cmd.load_packed([call_data["reads"]])
    table = call_cmd.build_depth_map(reads, (16,), 64, cpu)
    seq = call_cmd.load_records([call_data["ref"]])[0].seq
    row = encode_seqs([seq])[0][0, : len(seq)]
    k, w = 16, 100
    P = len(seq) - k + 1
    Pl = -(-P // 4)
    assert P % 4 and Pl >= w  # slices of one length, the last one padded
    whole = ShardedCallScan(make_mesh([cpu] * 4, dp=4), table, k, w)(row)
    part = ShardedCallScan(make_mesh([cpu] * 2, dp=2), table, k, w).scan(row, 4, 2)
    for name, v in whole.items():
        np.testing.assert_array_equal(part[name][: P - 2 * Pl], v[2 * Pl:], err_msg=name)
    halo = positional_depths(torch.from_numpy(row[2 * Pl - w: 2 * Pl + k - 1]), table, k,
                             plain_getter(table))
    np.testing.assert_array_equal(halo.numpy(), whole["depth"][2 * Pl - w: 2 * Pl])
    assert halo.any()
