"""``rkmh-tpu-torch stream -r REFS -f READS -k K -s S -M M -I I -o OUT
--dist-procs H --dist-rank R --dist-coordinator file://RDV`` on the H ranks
of one host: each rank's ``stream.run`` with the config that command line
makes (no device index, no ``mesh_devices``: the program places each rank
on its share of the host's cards), then the stripes ``OUT.0 .. OUT.H-1``
merged by ``dist_stream.merge_outputs`` (the merge tool's function) and
written to the job's output at once.

Rank 0 runs in this process, so that the harness's profiler traces it (its
spans, its card's device trace and peak memory); its run and the merge are
one recorded run a job (``observability.run_scope``).  Ranks 1 .. H-1 are
``spawn`` workers (``Ranks``) started by the first job (the harness's warm
job, so their start counts in set-up) and kept until this process exits;
the gloo group comes up once, with them, every wait in it bounded by
``GROUP_TIMEOUT_S``.  Each rank's answer is its own clocks (``rank_run``):
its run's seconds, its counter reduction's, the devices it took (the
program's ``dist.local_devices`` counter), its current card and its peak
memory; the job's ``stats`` hold every rank's, and ``rank_skew_s``, the
slowest rank's run seconds less the fastest's.

A job fails (raises) where a worker gives no answer within
``GROUP_TIMEOUT_S``, a worker finds a module of JAX or of the JAX package
loaded (``portbench.run.FORBIDDEN``), a rank's run fails, or, on CUDA, the
ranks did not each take ``cards_per_rank`` cards of their own.  The
harness's job interface keeps no state of its own, so the workers of a run
live in this module (``_RANKS``).
"""

from __future__ import annotations

import atexit
import glob
import io
import json
import multiprocessing
import os
import sys
import time

from rkmh_tpu_torch import observability
from rkmh_tpu_torch.commands import dist_stream, stream
from rkmh_tpu_torch.parallel import distributed

GROUP_TIMEOUT_S = 120
WORK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache",
                    "dist4")

SPANS = [(dist_stream, "load_or_build_panel", "panel"),
         (dist_stream, "_count_rows", "counter pass"),
         (dist_stream, "_iter_owned_batches", "input wait"),
         (dist_stream, "_step", "device step"),
         (stream, "format_lines_host", "format"),
         (dist_stream, "merge_outputs", "merge")]

_RANKS = None  # this process's Ranks, made by the first job


def rank_run(inputs: dict, cfg: dict, traffic: dict, rank: int, rdv: str, out: str,
             device: str) -> dict:
    """One rank's ``stream.run`` into ``<out>.<rank>`` -> its clocks: ``rc``,
    ``run_s``, ``counter_reduce_s`` (around ``dist_stream._reduce_counter``),
    ``local_devices`` (None where the program counts none), ``card`` (its
    current CUDA device after the run) and ``peak_bytes``."""
    import torch

    fl = traffic["flags"]
    cuda = device.startswith("cuda")
    reduce_s = []
    reduce_counter = dist_stream._reduce_counter

    def timed_reduce(tables):
        t0 = time.perf_counter()
        try:
            return reduce_counter(tables)
        finally:
            reduce_s.append(time.perf_counter() - t0)

    before = observability.COUNTERS.get("dist.local_devices", 0)
    dist_stream._reduce_counter = timed_reduce
    t0 = time.perf_counter()
    try:
        rc = stream.run(stream.StreamConfig(
            ref_files=[inputs["refs"]], read_files=[inputs["reads"]], ks=tuple(fl["ks"]),
            sketch_size=fl["sketch_size"], min_kmer_occ=fl.get("min_kmer_occ", -1),
            max_samples=fl.get("max_samples"), counter_size=cfg["counter_size"],
            batch_size=fl.get("batch_size", 0), out_file=out, device=device,
            dist_coordinator=rdv, dist_procs=cfg["ranks"], dist_rank=rank))
        if cuda:
            torch.cuda.synchronize()
    finally:
        dist_stream._reduce_counter = reduce_counter
    run_s = time.perf_counter() - t0
    after = observability.COUNTERS.get("dist.local_devices")
    return {"rank": rank, "rc": rc, "run_s": run_s,
            "counter_reduce_s": sum(reduce_s) if reduce_s else None,
            "local_devices": None if after is None else int(after - before),
            "card": torch.cuda.current_device() if cuda else None,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}


def _worker(conn, rank: int, ranks: int, rdv: str) -> None:
    """Rank ``rank`` of ``ranks``: join the group, then answer each job
    (``rank_run``'s arguments) with its clocks and the JAX modules loaded,
    until None or the end of the harness's process."""
    from portbench.run import FORBIDDEN

    try:
        distributed.initialize(rdv, ranks, rank, timeout_s=GROUP_TIMEOUT_S)
        while True:
            args = conn.recv()
            if args is None:
                break
            try:
                got = rank_run(*args)
            except Exception as e:  # reported to rank 0, which fails the job
                got = {"rank": rank, "error": repr(e)}
            got["forbidden"] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
            conn.send(got)
    except EOFError:  # the harness's process ended
        pass
    finally:
        _leave_group()


def _leave_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class Ranks:
    """Ranks 1 .. ranks - 1 as ``spawn`` workers, and the gloo group with
    this process as rank 0, its rendezvous a file store in ``work``."""

    def __init__(self, ranks: int, work: str):
        os.makedirs(work, exist_ok=True)
        store = os.path.join(work, "rdv")
        if os.path.exists(store):
            os.remove(store)
        self.rdv = f"file://{store}"
        self.work = work
        # the ranks of one host talk over the loopback; the input index stays here
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("RKMH_TPU_INPUT_INDEX", os.path.join(work, "idx"))
        mp = multiprocessing.get_context("spawn")
        self.conns, self.procs, self.broken = [], [], False
        for r in range(1, ranks):
            here, there = mp.Pipe()
            p = mp.Process(target=_worker, args=(there, r, ranks, self.rdv), daemon=True)
            p.start()
            there.close()
            self.conns.append(here)
            self.procs.append(p)
        atexit.register(self.close)
        distributed.initialize(self.rdv, ranks, 0, timeout_s=GROUP_TIMEOUT_S)

    def collect(self, deadline: float) -> list:
        """Every worker's answer, each by ``deadline`` (monotonic), else
        TimeoutError."""
        got = []
        for r, conn in enumerate(self.conns, 1):
            if not conn.poll(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(f"rank {r} gave no answer within {GROUP_TIMEOUT_S} s")
            got.append(conn.recv())
        return got

    def close(self) -> None:
        """Stop the workers (those that do not end in a few seconds are
        terminated) and leave the group."""
        for conn in self.conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join()
        self.conns, self.procs = [], []
        _leave_group()


def faults(answers: list, cfg: dict, device: str) -> list:
    """Why the ranks' answers fail the job (none: they pass)."""
    bad = [f"rank {a['rank']}: {a['error']}" for a in answers if "error" in a]
    bad += [f"rank {a['rank']} exited {a['rc']}" for a in answers if a.get("rc") not in (0, None)]
    bad += [f"rank {a['rank']} has modules of JAX or the JAX package loaded: {a['forbidden']}"
            for a in answers if a.get("forbidden")]
    if device.startswith("cuda") and not bad:
        took = [a["local_devices"] for a in answers]
        cards = [a["card"] for a in answers]
        if any(t != cfg["cards_per_rank"] for t in took) or len(set(cards)) != len(cards):
            bad.append(f"the ranks did not each take {cfg['cards_per_rank']} card(s) of their "
                       f"own: devices taken {took}, current cards {cards}")
    return bad


def job_run(ranks: Ranks, inputs: dict, cfg: dict, traffic: dict, sink, stats: dict,
            device: str) -> int:
    """One job on ``ranks``: every rank's run, then the merge into ``sink``."""
    if ranks.broken:
        raise RuntimeError("the rank workers failed in an earlier job")
    out = os.path.join(ranks.work, "out")
    for path in glob.glob(f"{out}.*"):  # the previous job's stripes, sidecar, checkpoints
        os.remove(path)
    for r, conn in enumerate(ranks.conns, 1):
        conn.send((inputs, cfg, traffic, r, ranks.rdv, out, device))
    merged = io.StringIO()
    try:
        with observability.run_scope("stream"):
            answers = [rank_run(inputs, cfg, traffic, 0, ranks.rdv, out, device)]
            answers += ranks.collect(time.monotonic() + GROUP_TIMEOUT_S)
            bad = faults(answers, cfg, device)
            if not bad:
                with open(f"{out}.dist.json") as fh:
                    batch = json.load(fh)["global_batch"]
                dist_stream.merge_outputs([f"{out}.{r}" for r in range(cfg["ranks"])], batch,
                                          merged)
    except BaseException:  # answers may be left unread: no later job can trust the workers
        ranks.broken = True
        raise
    run_s = [a.get("run_s") for a in answers]
    stats.update(rank_run_s=run_s, counter_reduce_s=[a.get("counter_reduce_s") for a in answers],
                 local_devices=[a.get("local_devices") for a in answers],
                 cards=[a.get("card") for a in answers],
                 peak_bytes=[a.get("peak_bytes") for a in answers])
    if None not in run_s:
        stats["rank_skew_s"] = max(run_s) - min(run_s)
    print(f"portbench: ranks' run s {run_s}, counter reduce s {stats['counter_reduce_s']}, "
          f"devices taken {stats['local_devices']}, cards {stats['cards']}, peak bytes "
          f"{stats['peak_bytes']}", file=sys.stderr)
    if bad:
        raise RuntimeError("; ".join(bad))
    sink.write(merged.getvalue())
    return 0


def run(inputs: dict, cfg: dict, traffic: dict, sink, stats: dict, device: str) -> int:
    global _RANKS
    if _RANKS is None:
        _RANKS = Ranks(cfg["ranks"], WORK)
    return job_run(_RANKS, inputs, cfg, traffic, sink, stats, device)
