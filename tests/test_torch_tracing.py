"""The port's tracer (``rkmh_tpu_torch/observability.py``) on the CPU.

With no profiler active a command records no run and opens no
``record_function``; under ``torch.profiler.profile`` each ``run()`` records
one run whose spans sit where the work happens: the reader thread's
``input.parse`` / ``input.unpack``, the consumer's ``input.wait``, one
``device.h2d`` a batch copy with the array's bytes, one ``device.fetch`` a
fetch group, one ``output.format`` a batch and one ``output.emit`` a chunk,
the -M ``counter.pass``, hpv16's ``hpv16.tables.<phase>`` and call's
phases, whose seconds the commands report (``Hpv16Tables.setup_s``,
``call_cmd.run(stats=)``).  An ``RKMH_TPU_PROFILE`` trace holds the reader
thread's spans on the trace's clock, inside the run's root event.  The
benchmark's readers of the spans (``portbench/program_spans.py``) give a
value in a traced run of a tiny cell and find nothing in an untraced one.
Inputs are synthetic (``rkmh_tpu_torch.synth``).
"""

import io
import json
import math
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from rkmh_tpu_torch import cli, observability, synth
from rkmh_tpu_torch.commands import call_cmd, common, hpv16_cmd, stream
from rkmh_tpu_torch.io.native import read_fastx_packed

READS, CHUNK, BATCH = 300, 100, 64
READER = "rkmh-read-ahead"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    refs, reads, _, _ = synth.write_workload(str(d), READS, 150, num_refs=4, genome_len=1200,
                                             seed=3, n_rate=0.01)
    hp = synth.write_hpv16_refpath(str(d / "hpv16"), seed=3, num_types=6, genome_len=1200)
    hp_reads, _ = synth.make_nanopore_reads(40, 5, hp, mean_len=800, min_len=800, max_len=800)
    synth.write_fastq_records(str(d / "hpv16.fq"), hp_reads)
    ref, call_reads, _, _ = synth.write_call_workload(str(d / "call"), n_reads=60, seed=5)
    return {"refs": refs, "reads": reads, "hpv16": str(d / "hpv16"),
            "hpv16_reads": str(d / "hpv16.fq"), "ref": ref, "call_reads": call_reads}


def _config(command, data):
    if command in ("stream", "stream -M"):
        return stream.run, stream.StreamConfig(
            ref_files=[data["refs"]], read_files=[data["reads"]], ks=(12,), device="cpu",
            batch_size=BATCH, chunk_reads=CHUNK,
            **({"min_kmer_occ": 2, "counter_size": 4099} if command == "stream -M" else {}))
    if command == "hpv16":
        return hpv16_cmd.run, hpv16_cmd.Hpv16Config(
            read_files=[data["hpv16_reads"]], refpath=data["hpv16"], ks=(16,), device="cpu",
            batch_size=8, chunk_reads=16, tst_file=False)
    return call_cmd.run, call_cmd.CallConfig(ref_files=[data["ref"]],
                                             read_files=[data["call_reads"]], ks=(16,),
                                             batch_size=16, device="cpu")


def _batches(path, chunk_reads, batch_size):
    """(chunks, the codes and lens of every batch) as the commands make them."""
    chunks = list(common.iter_packed_chunks([path], chunk_reads))
    return len(chunks), [(c, n) for ch in chunks
                         for _, c, n in common.bucketed_batches(ch, batch_size)]


def _traced(fn, cfg, **kw):
    """One run of ``fn(cfg)`` under a CPU profiler -> (its run record, the
    output, the number of ChunkedPipeline fetch groups)."""
    flushes = []
    flush = common.ChunkedPipeline._flush

    def counted(self, n):
        flushes.append(n)
        return flush(self, n)

    before = len(observability.finished_runs())
    out = io.StringIO()
    common.ChunkedPipeline._flush = counted
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert fn(cfg, out=out, **kw) == 0
    finally:
        common.ChunkedPipeline._flush = flush
    runs = observability.finished_runs()
    assert len(runs) == before + 1  # one run record a run()
    return runs[-1], out.getvalue(), len(flushes)


def _named(run, name, thread=None):
    return [s for s in run.spans if s.name == name and thread in (None, s.thread)]


def _parents(run) -> Counter:
    by_id = {s.id: s.name for s in run.spans}
    return Counter((s.name, by_id.get(s.parent)) for s in run.spans)


def test_no_profiler_records_nothing(data, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = len(observability.finished_runs())
    for command in ("stream", "stream -M", "hpv16", "call"):
        fn, cfg = _config(command, data)
        assert fn(cfg, out=io.StringIO()) == 0
    assert len(observability.finished_runs()) == before
    with observability.span("x", 8) as s:
        pass
    assert s.seconds >= 0 and s.nbytes == 8


def test_stream_spans(data):
    fn, cfg = _config("stream", data)
    run, out, flushes = _traced(fn, cfg)
    n_chunks, batches = _batches(data["reads"], CHUNK, BATCH)
    assert run.command == "stream" and len(out.splitlines()) == READS
    assert n_chunks == 3 and len(batches) == 6
    root = _named(run, "run")
    assert len(root) == 1 and root[0].parent is None and root[0].id == run.root
    assert _parents(run) == Counter({
        ("run", None): 1,
        # the references on this thread, then the reads' chunks on the reader
        # thread, whose last call finds the end of the file
        ("input.parse", "run"): 1 + n_chunks + 1,
        ("input.unpack", "input.parse"): 1 + n_chunks,
        ("input.wait", "run"): n_chunks + 1,     # the last get takes the end marker
        ("input.handoff", "run"): len(_named(run, "input.handoff")),
        ("device.h2d", "run"): len(batches),
        ("device.fetch", "run"): flushes,
        ("output.format", "run"): len(batches),
        ("output.emit", "run"): n_chunks})
    assert len(_named(run, "input.parse", READER)) == n_chunks + 1
    assert len(_named(run, "input.unpack", READER)) == n_chunks
    assert all(s.thread == READER for s in _named(run, "input.handoff"))
    main = threading.current_thread().name
    assert len([s for s in run.spans if s.thread == main]) == len(run.spans) - (
        2 * n_chunks + 1 + len(_named(run, "input.handoff")))
    assert [s.nbytes for s in sorted(_named(run, "device.h2d"), key=lambda s: s.start_ns)] == \
        [c.nbytes for c, _ in batches]
    assert sum(s.nbytes for s in _named(run, "device.fetch")) == 3 * 4 * READS  # [3, B] int32
    assert all(s.end_ns >= s.start_ns for s in run.spans)


def test_stream_depth_spans(data):
    fn, cfg = _config("stream -M", data)
    run, _, flushes = _traced(fn, cfg)
    n_chunks, batches = _batches(data["reads"], CHUNK, BATCH)
    parents = _parents(run)
    assert run.command == "stream"
    assert parents[("counter.pass", "run")] == 1
    # pass 1 inside the counter pass, then pass 2 under the root
    assert parents[("input.wait", "counter.pass")] == n_chunks + 1
    assert parents[("input.wait", "run")] == n_chunks + 1
    assert parents[("input.parse", "run")] == 1 + 2 * (n_chunks + 1)  # the references first
    assert len(_named(run, "input.parse", READER)) == 2 * (n_chunks + 1)
    assert parents[("device.h2d", "counter.pass")] == 2 * len(batches)  # codes and lens
    assert parents[("device.h2d", "run")] == len(batches)
    assert len(_named(run, "device.fetch")) == flushes
    assert sorted(s.nbytes for s in _named(run, "device.h2d")) == sorted(
        [c.nbytes for c, _ in batches] * 2 + [n.nbytes for _, n in batches])
    (cp,) = _named(run, "counter.pass")
    assert all(cp.start_ns <= s.start_ns <= s.end_ns <= cp.end_ns
               for s in run.spans if s.parent == cp.id)


def test_hpv16_spans_and_setup_laps(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    built = []
    build = hpv16_cmd.build_tables

    def keep(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    monkeypatch.setattr(hpv16_cmd, "build_tables", keep)
    fn, cfg = _config("hpv16", data)
    run, out, flushes = _traced(fn, cfg)
    n_chunks, batches = _batches(data["hpv16_reads"], 16, 8)
    assert run.command == "hpv16" and len(out.splitlines()) == 40
    (tb,) = built
    assert set(tb.setup_s) == {"parse", "hash", "family_unique", "count", "device_build"}
    laps = {s.name: s for s in run.spans if s.name.startswith("hpv16.tables.")}
    assert set(laps) == {f"hpv16.tables.{k}" for k in tb.setup_s}
    for k, v in tb.setup_s.items():
        assert v == laps[f"hpv16.tables.{k}"].seconds and v >= 0
        assert laps[f"hpv16.tables.{k}"].parent == run.root
    parents = _parents(run)
    # the panel's two files parsed on this thread inside the parse lap
    assert parents[("input.parse", "hpv16.tables.parse")] == 2
    assert len(_named(run, "input.parse", READER)) == n_chunks + 1
    assert parents[("input.unpack", "input.parse")] == n_chunks + 2
    assert parents[("input.wait", "run")] == n_chunks + 1
    assert parents[("device.h2d", "run")] == len(batches)
    assert [s.nbytes for s in sorted(_named(run, "device.h2d"), key=lambda s: s.start_ns)] == \
        [c.nbytes for c, _ in batches]
    assert parents[("device.fetch", "run")] == flushes
    assert parents[("output.format", "run")] == len(batches)
    assert parents[("output.emit", "run")] == n_chunks


def test_call_spans_and_stats(data):
    """call's spans and stats: its depth map keeps the hashes where they
    are made (no fetch) and copies no map."""
    fn, cfg = _config("call", data)
    stats = {}
    run, out, _ = _traced(fn, cfg, stats=stats)
    assert run.command == "call" and out.startswith("##fileformat=VCF")
    assert {"parse_s", "scan_s", "extract_s", "write_s", "read_hashing_s", "map_unique_s",
            "map_layout_s", "map_copy_s", "map_keys", "map_bits", "map_overflow", "map_bytes",
            "map_part_bytes", "map_hashes_sorted_on_device"} <= set(stats)
    assert stats["map_copy_s"] == 0.0
    one = {s.name: s for s in run.spans}
    for key, name in (("parse_s", "call.parse"), ("read_hashing_s", "call.depth_map.hash"),
                      ("map_unique_s", "call.depth_map.unique"),
                      ("map_layout_s", "call.depth_map.layout"), ("scan_s", "call.scan"),
                      ("extract_s", "output.format"), ("write_s", "output.emit")):
        assert len(_named(run, name)) == 1 and stats[key] == one[name].seconds
        assert one[name].parent == run.root
    assert not _named(run, "call.depth_map.copy")
    reads = read_fastx_packed(data["call_reads"])
    batches = [(c, n) for _, c, n in common.bucketed_batches(reads, 16)]
    assert stats["map_hashes_sorted_on_device"] == \
        int(np.maximum(reads.lens.astype(np.int64) - 15, 0).sum())
    parents = _parents(run)
    assert parents[("input.parse", "call.parse")] == 1   # the reads, on this thread
    assert parents[("input.unpack", "input.parse")] == 1
    assert parents[("device.h2d", "call.depth_map.hash")] == 2 * len(batches)
    assert parents[("device.fetch", "call.depth_map.hash")] == 0
    assert parents[("device.h2d", "call.scan")] == parents[("device.fetch", "call.scan")] == 1
    h2d = {s.parent: [] for s in _named(run, "device.h2d")}
    for s in sorted(_named(run, "device.h2d"), key=lambda s: s.start_ns):
        h2d[s.parent].append(s.nbytes)
    assert h2d[one["call.depth_map.hash"].id] == [x.nbytes for b in batches for x in b]
    with open(data["ref"]) as fh:
        ref_len = sum(len(ln.strip()) for ln in fh if not ln.startswith(">"))
    assert h2d[one["call.scan"].id] == [ref_len]
    assert all(s.thread == threading.current_thread().name for s in run.spans)


def test_nested_runs_record_once(data):
    fn, cfg = _config("stream", data)
    before = len(observability.finished_runs())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with observability.run_scope("classify"):
            assert fn(cfg, out=io.StringIO()) == 0
    runs = observability.finished_runs()
    assert len(runs) == before + 1 and runs[-1].command == "classify"
    assert len(_named(runs[-1], "run")) == 1


def test_spans_parent_by_thread():
    """A span's parent is the enclosing span on its own thread, else the
    run's root; runs are kept, the newest MAX_RUNS."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with observability.run_scope("t"):
            with observability.span("outer"):
                t = threading.Thread(target=lambda: observability.span("other").__enter__()
                                     .__exit__(None, None, None), name="worker")
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
                with observability.span("inner", 5):
                    pass
    run = observability.finished_runs()[-1]
    assert _parents(run) == Counter({("run", None): 1, ("outer", "run"): 1,
                                     ("other", "run"): 1, ("inner", "outer"): 1})
    assert _named(run, "other")[0].thread == "worker"
    assert _named(run, "inner")[0].nbytes == 5
    assert observability._finished.maxlen == observability.MAX_RUNS == 1024


def test_profile_trace_holds_the_reader_thread(data, tmp_path, monkeypatch, capsys):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("RKMH_TPU_PROFILE", str(trace_dir))
    argv = ["stream", "-r", data["refs"], "-f", data["reads"], "-k", "12", "--batch-size",
            str(BATCH), "--chunk-reads", str(CHUNK), "--device", "cpu"]
    assert cli.main(argv) == 0
    capsys.readouterr()
    run = observability.finished_runs()[-1]
    with open(trace_dir / observability.TRACE_FILE) as fh:
        trace = json.load(fh)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    roots = [e for e in events if e["name"] == "run" and e.get("cat") == "user_annotation"]
    assert len(roots) == 1
    (root,) = roots
    parse = [e for e in events if e["name"] == "input.parse" and e["tid"] != root["tid"]]
    assert len(parse) == len(_named(run, "input.parse", READER)) == READS // CHUNK + 1
    assert all(root["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= root["ts"] + root["dur"] for e in parse)
    assert {e["args"]["name"] for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("tid") == parse[0]["tid"]} == {READER}
    (rec,) = _named(run, "run")
    converted = (run.wall_ns(rec.start_ns) - trace["baseTimeNanoseconds"]) / 1000
    assert abs(converted - float(root["ts"])) < 1000  # within 1 ms
    # the main thread's spans came through the profiler itself
    assert any(e["name"] == "input.wait" and e["tid"] == root["tid"] for e in events)


NEW_METRICS = ("input_parse_s", "input_wait_s", "copy_s", "output_s", "counter_pass_s")


@pytest.mark.parametrize("traffic", ["stream", "lineage"])
def test_portbench_span_metrics(traffic, tmp_path, monkeypatch):
    from portbench import run as bench
    from portbench.tests.conftest import tiny

    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "cache"))
    cell = {"stream": "zika.stream", "lineage": "hpv16.lineage"}[traffic]
    spec = bench.load_json(bench.ROOT, "BENCHMARK.json")
    mine = [m for m in spec["per_layer"] if m["name"].split(".")[0] in NEW_METRICS
            and cell in m["workloads"]]
    assert len(mine) == 4
    read = bench.metric_reader
    monkeypatch.setattr(bench, "metric_reader", lambda name: (
        (lambda rec: rec["window_s"]) if name == "_window" else read(name)))
    cfg, tr = tiny(traffic)
    out = bench.run_cell(cfg, tr, 3, 0.0, True, mine + [{"name": "_window", "unit": "s"}],
                         "cpu", 0.0)
    assert out["correct"]
    values = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(values) == {m["name"] for m in mine} | {"_window"}
    assert all(math.isfinite(v) and v >= 0 for v in values.values())
    wait = values[f"input_wait_s.{'stream' if traffic == 'stream' else 'hpv16'}"]
    assert wait * out["attempted"] <= values["_window"]
    before = len(observability.finished_runs())
    assert bench.run_cell(cfg, tr, 3, 0.0, False, [], "cpu", 0.0)["correct"]
    assert len(observability.finished_runs()) == before


def test_span_reader_finds_nothing_without_runs(monkeypatch):
    from portbench import program_spans

    monkeypatch.setattr(observability, "_finished", type(observability._finished)(maxlen=4))
    assert program_spans.mean_seconds({"jobs": [{}]}, "input.wait") is None
    monkeypatch.delattr(observability, "finished_runs")
    assert program_spans.mean_seconds({"jobs": [{}]}, "input.wait") is None
