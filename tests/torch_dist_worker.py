"""Rank worker for the port's multi-process tests (gloo on the CPU).

    python tests/torch_dist_worker.py <coordinator> <procs> <rank> <jobs.json> <results.json>

Runs a list of jobs, in order, as one rank of a group of ``procs``
processes (``rkmh_tpu_torch.parallel.distributed``: the group comes up at
the first drain and serves every later one).  A job is one of

* ``{"run": command, "cfg": {...}, "mesh": n | [n per rank] | null,
  "stdout": path | null}``: the ``run`` of a command's config (stream,
  filter, hash, count, search, hpv16, call) with this rank's --dist-*
  settings; ``mesh`` lays the rank's grid over n entries of the config's
  device (the ``mesh_devices`` seam); ``stdout`` takes what the drain
  writes to its output stream into ``<path>.<rank>``;
* ``{"cli": [args]}``: ``rkmh-tpu-torch`` with these arguments and this
  rank's --dist-* flags;
* ``"staged": true`` on a ``run`` or ``cli`` job: its ranks sum their
  counters through the host (``distributed.can_sum_in_place`` stood in
  for by False), where they would sum them in place;
* ``{"sums": path, "size": n, "seed": s}``: one [n] int32 table a rank,
  drawn from (s, rank) over the whole int32 range, summed over the group
  in place and staged (``dist_stream._reduce_counter`` after each route's
  agreement), both sums saved to ``<path>.<rank>.npz`` (keys ``in_place``,
  ``staged``);
* ``{"cut": path, "rank": r, "lines": n, "torn": bool}``: rank r keeps the
  first n lines of its file ``path`` (and, with ``torn``, half of the
  next one), as an interrupted run leaves it.

The results file gets each job's exit code (or the exception) as it ends,
and the counter sums it made on each route (``routes``: the job's
``dist.counter_reduce.in_place`` and ``.staged`` counts).
``run_pair`` starts the ranks and waits for them with a timeout, killing
every rank when one fails or the time runs out; ``run_jax_pair`` does the
same for rkmh-tpu's CLI (two processes of 4 virtual CPU devices each, as
``tests/test_distributed.py`` runs them), which the tests hold the port's
stripes against.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ("in_place", "staged")  # dist_stream._reduce_counter's, by their counters


def _cut(path: str, lines: int, torn: bool) -> None:
    with open(path, "rb") as fh:
        data = fh.readlines()
    keep = b"".join(data[:lines])
    if torn and lines < len(data):
        keep += data[lines][: len(data[lines]) // 2]
    with open(path, "wb") as fh:
        fh.write(keep)


@contextlib.contextmanager
def _staged(on: bool):
    """Within: the ranks agree to sum through the host, where ``on``."""
    from rkmh_tpu_torch.parallel import distributed

    can = distributed.can_sum_in_place
    if on:
        distributed.can_sum_in_place = lambda *args: False
    try:
        yield
    finally:
        distributed.can_sum_in_place = can


def _sums(job: dict, coordinator: str, procs: int, rank: int) -> int:
    import numpy as np
    import torch

    from rkmh_tpu_torch.commands import dist_stream
    from rkmh_tpu_torch.parallel import distributed

    distributed.initialize(coordinator, procs, rank)
    table = np.random.default_rng([job["seed"], rank]).integers(
        -2**31, 2**31, job["size"], dtype=np.int64).astype(np.int32)
    got = {}
    for route in ("in_place", "staged"):
        with _staged(route == "staged"):
            distributed.agree_in_place([torch.device("cpu")])
        got[route] = dist_stream._reduce_counter([torch.from_numpy(table.copy())]).numpy()
    np.savez(f"{job['sums']}.{rank}.npz", **got)
    return 0


def _run(job: dict, coordinator: str, procs: int, rank: int) -> int:
    import torch

    from rkmh_tpu_torch import cli
    from rkmh_tpu_torch.commands import (
        call_cmd, count_cmd, filter_cmd, hash_cmd, hpv16_cmd, search_cmd, stream,
    )

    if "sums" in job:
        return _sums(job, coordinator, procs, rank)
    if "cli" in job:
        return cli.main([*job["cli"], "--dist-coordinator", coordinator, "--dist-procs",
                         str(procs), "--dist-rank", str(rank)])
    cfg = dict(job["cfg"])
    mesh = job.get("mesh")
    if isinstance(mesh, list):
        mesh = mesh[rank]
    if mesh:
        cfg["mesh_devices"] = (torch.device(cfg.get("device", "cpu")),) * mesh
    cfg.update(dist_coordinator=coordinator, dist_procs=procs, dist_rank=rank)
    mod, config = {"stream": (stream, stream.StreamConfig),
                   "filter": (filter_cmd, filter_cmd.FilterConfig),
                   "hash": (hash_cmd, hash_cmd.HashConfig),
                   "count": (count_cmd, count_cmd.CountConfig),
                   "search": (search_cmd, search_cmd.SearchConfig),
                   "hpv16": (hpv16_cmd, hpv16_cmd.Hpv16Config),
                   "call": (call_cmd, call_cmd.CallConfig)}[job["run"]]
    if not job.get("stdout"):
        return mod.run(config(**cfg))
    with open(f"{job['stdout']}.{rank}", "w") as out:
        return mod.run(config(**cfg), out)


def main(argv) -> int:
    coordinator, procs, rank, jobs_path, results_path = (
        argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4])
    sys.path.insert(0, REPO)
    from rkmh_tpu_torch import observability

    with open(jobs_path) as fh:
        jobs = json.load(fh)
    results = []
    for job in jobs:
        if "cut" in job:
            if job["rank"] == rank:
                _cut(job["cut"], job["lines"], job.get("torn", False))
            results.append({"rc": 0})
        else:
            before = {k: observability.COUNTERS[f"dist.counter_reduce.{k}"] for k in ROUTES}
            try:
                with _staged(job.get("staged", False)):
                    rc = _run(job, coordinator, procs, rank)
                results.append({"rc": rc, "routes": {
                    k: observability.COUNTERS[f"dist.counter_reduce.{k}"] - before[k]
                    for k in ROUTES}})
            except Exception as e:  # reported to the test, which names the job
                results.append({"rc": None, "error": repr(e),
                                "traceback": traceback.format_exc()})
        with open(results_path, "w") as fh:
            json.dump(results, fh)
        if results[-1]["rc"] is None:
            return 1
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(tmp: str) -> dict:
    """A rank's environment: the repo on the path, the input index and no
    panel cache in ``tmp``, gloo on the loopback interface."""
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": REPO,
            "HOME": os.path.expanduser("~"), "RKMH_TPU_PANEL_CACHE": "0",
            "RKMH_TPU_INPUT_INDEX": os.path.join(tmp, "idxcache"),
            "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}


def wait_all(procs, timeout: float, grace: float = 20) -> None:
    """Wait for every process.  When one exits with an error, the others
    get ``grace`` seconds (a peer blocked in a collective would otherwise
    wait out the group's timeout); past ``timeout`` or the grace every
    process still running is killed and TimeoutError raised."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return
        if any(c not in (None, 0) for c in codes):
            deadline = min(deadline, time.monotonic() + grace)
        if time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            raise TimeoutError(f"killed after {timeout} s (exit codes {codes})")
        time.sleep(0.05)


def run_pair(jobs: list, tmp: str, procs: int = 2, timeout: float = 240,
             store: str = "file", cwd: str | None = None) -> list:
    """Run ``jobs`` on ``procs`` port ranks in ``cwd`` (None: this
    process's), their group's rendezvous a ``file://`` store in ``tmp`` or
    (``store="tcp"``) a free loopback port; -> each rank's (results,
    stderr).  Raises if a rank fails or hangs."""
    jobs_path = os.path.join(tmp, "jobs.json")
    with open(jobs_path, "w") as fh:
        json.dump(jobs, fh)
    coordinator = (f"127.0.0.1:{free_port()}" if store == "tcp"
                   else f"file://{os.path.join(tmp, 'store')}")
    results = [os.path.join(tmp, f"results.{r}.json") for r in range(procs)]
    logs = [os.path.join(tmp, f"rank.{r}.err") for r in range(procs)]
    ranks = []
    try:
        for r in range(procs):
            with open(logs[r], "w") as err:
                ranks.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), coordinator, str(procs), str(r),
                     jobs_path, results[r]], cwd=cwd, env=rank_env(tmp),
                    stdout=subprocess.DEVNULL, stderr=err))
        wait_all(ranks, timeout)
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for r, p in enumerate(ranks):
        with open(logs[r]) as fh:
            err = fh.read()
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
        with open(results[r]) as fh:
            got.append((json.load(fh), err))
    return got


def run_jax_pair(argv: list, tmp: str, procs: int = 2, timeout: float = 300,
                 stdout: str | None = None, cwd: str = REPO) -> list:
    """``python -m rkmh_tpu.cli <argv> --dist-*`` on ``procs`` processes
    of 4 virtual CPU devices each, in ``cwd``, each rank's stdout into
    ``<stdout>.<rank>`` (dropped without ``stdout``); -> each rank's
    stderr.  Raises if one fails or hangs."""
    env = {**rank_env(tmp), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    coordinator = f"127.0.0.1:{free_port()}"
    logs = [os.path.join(tmp, f"jax.{r}.err") for r in range(procs)]
    ranks = []
    try:
        for r in range(procs):
            with open(logs[r], "w") as err, \
                    open(f"{stdout}.{r}" if stdout else os.devnull, "w") as out:
                ranks.append(subprocess.Popen(
                    [sys.executable, "-m", "rkmh_tpu.cli", *argv, "--dist-coordinator",
                     coordinator, "--dist-procs", str(procs), "--dist-rank", str(r)],
                    cwd=cwd, env=env, stdout=out, stderr=err))
        wait_all(ranks, timeout)
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = []
    for r, p in enumerate(ranks):
        with open(logs[r]) as fh:
            errs.append(fh.read())
        if p.returncode != 0:
            raise AssertionError(f"rkmh-tpu rank {r} exited {p.returncode}:\n{errs[r][-3000:]}")
    return errs


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
