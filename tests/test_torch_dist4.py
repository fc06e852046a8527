"""Four port ranks of one host, as the benchmark's ``zika.stream_dist4``
runs them (``portbench/jobs/dist_stream.py``): rank 0 in this process,
ranks 1-3 ``spawn`` workers of the job module, one gloo group on the CPU
for the module.  One job of ``stream -M 2 -I 5`` over a small zika-shaped
workload (60 references, 300 reads; a global batch of 64, so each rank
owns rows of every batch), run under a profiler so that rank 0's spans
are recorded: the merged stripes must equal the plain reference
(``portbench/reference/stream.expected``) and one process's ``stream``
output byte for byte; the CPU ranks sum the -M counter in place, on
gloo.  On a host of four cards (``cuda``), four ranks joined with no
device seam each take a card of their own; on a host of two or more,
as many ranks as cards run the job on cards of their own, sum the counter
on NCCL and give one process's output.  Tolerance: none; the outputs are
text.
"""

import io
import multiprocessing
import os

import pytest
import torch

from portbench.jobs import dist_stream as job
from portbench.reference import stream as reference
from rkmh_tpu_torch import observability, synth
from rkmh_tpu_torch.commands import dist_stream, stream
from rkmh_tpu_torch.parallel import distributed

RANKS = 4
CFG = {"counter_size": 100_000, "ranks": RANKS, "cards_per_rank": 1}
TRAFFIC = {"flags": {"ks": [12], "sketch_size": 1000, "min_kmer_occ": 2, "max_samples": 5,
                     "batch_size": 64}}


@pytest.fixture(scope="module")
def dist4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist4"))
    refs, reads, _, _ = synth.write_workload(d, 300)
    inputs = {"refs": refs, "reads": reads}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLOO_SOCKET_IFNAME", "lo")
        mp.setenv("RKMH_TPU_INPUT_INDEX", os.path.join(d, "idx"))
        mp.setenv("OMP_NUM_THREADS", "1")  # four ranks' torch threads on the test's cores
        ranks = job.Ranks(RANKS, os.path.join(d, "work"))
        try:
            sink, stats = io.StringIO(), {}
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                rc = job.job_run(ranks, inputs, CFG, TRAFFIC, sink, stats, "cpu")
            recorded = observability.finished_runs()[-1]
        finally:
            ranks.close()
    fl = TRAFFIC["flags"]
    one = io.StringIO()
    assert stream.run(stream.StreamConfig(
        ref_files=[refs], read_files=[reads], ks=(12,), sketch_size=fl["sketch_size"],
        min_kmer_occ=fl["min_kmer_occ"], max_samples=fl["max_samples"],
        counter_size=CFG["counter_size"], batch_size=fl["batch_size"], device="cpu"), one) == 0
    return {"rc": rc, "merged": sink.getvalue(), "stats": stats, "run": recorded,
            "one": one.getvalue(), "inputs": inputs}


def test_merged_stripes_equal_reference_and_one_process(dist4):
    assert dist4["rc"] == 0
    want, _ = reference.expected(dist4["inputs"], CFG, TRAFFIC, torch.device("cpu"))
    assert dist4["merged"].count("\n") == 300
    assert dist4["merged"] == want
    assert dist4["merged"] == dist4["one"]


def test_ranks_report_their_clocks_spans_and_counter(dist4):
    st = dist4["stats"]
    assert st["local_devices"] == [1] * RANKS
    assert all(s > 0 for s in st["rank_run_s"] + st["counter_reduce_s"])
    assert st["rank_skew_s"] == max(st["rank_run_s"]) - min(st["rank_run_s"])
    names = {s.name for s in dist4["run"].spans}
    assert {"dist.join", "dist.counter_reduce", "dist.counter_reduce.allreduce",
            "dist.merge"} <= names
    # CPU ranks of one device each sum the counter in place, on gloo: no fetch, no fill
    assert not {"dist.counter_reduce.fetch", "dist.counter_reduce.fill"} & names
    assert observability.COUNTERS["dist.counter_reduce.in_place"] >= 1
    merge = [s for s in dist4["run"].spans if s.name == "dist.merge"]
    assert [s.nbytes for s in merge] == [len(dist4["merged"])]
    assert observability.COUNTERS["dist.local_devices"] >= 1


def _place(rank: int, store: str, q) -> None:
    """A rank of the four-card check: join the group with no device seam
    and report the devices it took and its current card."""
    ctx = dist_stream._join_group(stream.StreamConfig(
        dist_coordinator=f"file://{store}", dist_procs=RANKS, dist_rank=rank), "stream")
    q.put((rank, [str(d) for d in ctx.local], str(ctx.device), torch.cuda.current_device()))
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_four_ranks_take_a_card_each(tmp_path, monkeypatch):
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} CUDA devices")
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    mp = multiprocessing.get_context("spawn")
    q = mp.Queue()
    procs = [mp.Process(target=_place, args=(r, str(tmp_path / "store"), q))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    got = sorted(q.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(30)
        assert not p.is_alive()
    assert got == [(r, [f"cuda:{r}"], f"cuda:{r}", r) for r in range(RANKS)]


@pytest.mark.cuda
def test_ranks_on_cards_of_their_own_sum_on_nccl(dist4, tmp_path, monkeypatch):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    n = torch.cuda.device_count()
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("RKMH_TPU_INPUT_INDEX", str(tmp_path / "idx"))
    routes = ("dist.counter_reduce.in_place", "dist.counter_reduce.staged")
    before = [observability.COUNTERS[k] for k in routes]
    ranks = job.Ranks(n, str(tmp_path / "work"))
    try:
        sink, stats = io.StringIO(), {}
        rc = job.job_run(ranks, dist4["inputs"], {**CFG, "ranks": n}, TRAFFIC, sink, stats,
                         "cuda")
        backend = torch.distributed.get_backend(distributed.in_place_group())
    finally:
        ranks.close()
    assert rc == 0
    assert stats["local_devices"] == [1] * n and stats["cards"] == list(range(n))
    assert [observability.COUNTERS[k] - b for k, b in zip(routes, before)] == [1, 0]
    assert backend == "nccl"
    assert sink.getvalue() == dist4["one"]
