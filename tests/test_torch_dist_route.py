"""Where the --dist-* ranks sum their counters (``distributed.agree_in_place``).

The route decision, each rank's part and the group's agreement, with the
gathers and ``allmin`` stood in for: in place (gloo for CPU ranks, one
NCCL group for ranks on cards of their own) or staged through the host
(ranks that share a card, a rank's grid of several devices, a torch
without NCCL, and every rank where one rank cannot).  Then two CPU ranks
on gloo (``tests/torch_dist_worker.py``): the in-place sum equals the
staged sum of the same tables bit for bit (int32 addition wraps alike on
both), and ``stream -M 2 -I 5 -o`` and ``count -o --dump`` give the same
stripes, ``.mctr`` blocks (``fp`` and ``rows``) and tables on each route.
Tolerance: none.
"""

import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

import torch_dist_worker
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.parallel import distributed

CPU = ("cpu", None)


def _rank(local, uuids=None, nccl=True):
    """One rank's side of a case: its local devices (kind, index), the UUID
    of each card it sees by index, and whether its torch has NCCL."""
    return {"local": [torch.device(*d) if d[1] is not None else torch.device(d[0])
                      for d in local],
            "uuids": uuids or {}, "nccl": nccl}


@pytest.mark.parametrize("ranks,route", [
    ([_rank([CPU]), _rank([CPU])], "gloo"),
    ([_rank([("cuda", 0)], {0: "GPU-a"}), _rank([("cuda", 1)], {1: "GPU-b"})], "nccl"),
    ([_rank([("cuda", 0)], {0: "GPU-a"}, nccl=False),
      _rank([("cuda", 1)], {1: "GPU-b"}, nccl=False)], None),
    ([_rank([("cuda", 0)], {0: "GPU-a"}), _rank([("cuda", 0)], {0: "GPU-a"})], None),
    ([_rank([("cuda", 0), ("cuda", 1)], {0: "GPU-a", 1: "GPU-b"}),
      _rank([("cuda", 2), ("cuda", 3)], {2: "GPU-c", 3: "GPU-d"})], None),
    ([_rank([("cuda", 0)], {0: "GPU-a"}), _rank([("cuda", 1)], {1: "GPU-b"}, nccl=False)], None),
    ([_rank([CPU]), _rank([("cuda", 0)], {0: "GPU-a"})], None),
    ([_rank([("cuda", 0)], {0: "GPU-a"}), _rank([("cuda", 0)], {0: "GPU-b"})], "nccl"),
], ids=["cpu", "own-card-nccl", "own-card-no-nccl", "shared-card", "two-card-grid",
        "mixed-nccl", "mixed-kinds", "own-card-same-index"])
def test_route_decision(monkeypatch, ranks, route):
    """Each rank's ``can_sum_in_place`` and the route every rank agrees on:
    its own flag goes into the ``allmin``, whose answer is the least flag
    of the group; a card is told by its UUID, not by the index a rank sees
    it under (the last case: each rank sees its own card as cuda:0)."""
    world = object()
    monkeypatch.setattr(distributed_c10d._world, "default_pg", world)
    monkeypatch.setattr(distributed, "_in_place", (None, None))
    made = []
    monkeypatch.setattr(dist, "new_group", lambda **kw: made.append(kw) or ("nccl", len(made)))

    def enter(r):
        me = ranks[r]
        monkeypatch.setattr(distributed, "process_index", lambda: r)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda d: types.SimpleNamespace(uuid=me["uuids"][d.index]))
        monkeypatch.setattr(dist, "is_nccl_available", lambda: me["nccl"])
        monkeypatch.setattr(distributed, "_nccl", (None, None))  # each rank is its own process

    keys = []
    for r, me in enumerate(ranks):
        enter(r)
        keys.append(distributed.device_key(me["local"][0]))
    flags = [distributed.can_sum_in_place(me["local"], keys, r, me["nccl"])
             for r, me in enumerate(ranks)]
    blocks = np.concatenate([np.frombuffer(k.encode().ljust(distributed.KEY_BYTES, b"\0"),
                                           dtype=np.uint8) for k in keys])
    monkeypatch.setattr(distributed, "all_gather_blocks", lambda block: blocks)
    for r, me in enumerate(ranks):
        enter(r)

        def allmin(value, r=r):
            assert bool(value) == flags[r]
            return min(flags)

        monkeypatch.setattr(distributed, "allmin", allmin)
        assert distributed.agree_in_place(me["local"]) == (route is not None)
        group = distributed.in_place_group()
        want = {"gloo": world, "nccl": ("nccl", len(made)), None: None}[route]
        assert group == want, r
    assert [kw["backend"] for kw in made] == ["nccl"] * (len(ranks) if route == "nccl" else 0)
    if route == "nccl":
        assert flags == [True] * len(ranks)


def test_nccl_group_lives_with_its_default_group(monkeypatch):
    """One NCCL group a default group: a later join under the same default
    group takes it again, a join under a new one makes another, and a
    route agreed under an old default group is no route."""
    made = []
    monkeypatch.setattr(dist, "new_group", lambda **kw: made.append(kw) or len(made))
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid="GPU-a"))
    monkeypatch.setattr(distributed, "_nccl", (None, None))
    monkeypatch.setattr(distributed, "_in_place", (None, None))
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    monkeypatch.setattr(distributed, "all_gather_blocks", lambda block: block)
    monkeypatch.setattr(distributed, "allmin", int)
    card = [torch.device("cuda", 0)]
    first, second = object(), object()
    monkeypatch.setattr(distributed_c10d._world, "default_pg", first)
    assert distributed.agree_in_place(card) and distributed.agree_in_place(card)
    assert distributed.in_place_group() == 1 and len(made) == 1
    monkeypatch.setattr(distributed_c10d._world, "default_pg", second)
    assert distributed.in_place_group() is None
    assert distributed.agree_in_place(card)
    assert distributed.in_place_group() == 2 and len(made) == 2
    assert made[0]["timeout"].total_seconds() == distributed.DEFAULT_TIMEOUT_S


COUNTER = 100_003 * 2  # divisible by the 2 dp shards


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_route"))
    refs, reads, _, _ = synth.write_workload(d, 200, num_refs=12)
    p = {n: os.path.join(d, n) for n in ("in_place", "staged", "sums")}
    stream_cfg = dict(ref_files=[refs], read_files=[reads], ks=[12], sketch_size=200,
                      batch_size=64, min_kmer_occ=2, max_samples=5, counter_size=COUNTER,
                      device="cpu")
    count_cfg = dict(read_files=[reads], ks=[12], batch_size=64, counter_size=COUNTER,
                     dump=True, device="cpu")
    jobs = []
    for route in ("in_place", "staged"):
        jobs += [{"run": "stream", "cfg": {**stream_cfg, "out_file": p[route] + ".rk"},
                  "staged": route == "staged"},
                 {"run": "count", "cfg": {**count_cfg, "out_file": p[route] + ".npz"},
                  "stdout": p[route] + ".dump", "staged": route == "staged"}]
    jobs.append({"sums": p["sums"], "size": 100_000, "seed": 20260})
    ranks = torch_dist_worker.run_pair(jobs, d)
    return {"p": p, "ranks": ranks}


def test_each_job_took_its_route(runs):
    for results, _ in runs["ranks"]:
        assert [r["routes"] for r in results[:4]] == [
            {"in_place": 1, "staged": 0}, {"in_place": 1, "staged": 0},
            {"in_place": 0, "staged": 1}, {"in_place": 0, "staged": 1}]
        assert results[4]["routes"] == {"in_place": 1, "staged": 1}


def test_in_place_sum_equals_staged_sum_bit_for_bit(runs):
    tables = [np.random.default_rng([20260, r]).integers(-2**31, 2**31, 100_000, dtype=np.int64)
              for r in range(2)]
    want = ((tables[0] + tables[1] + 2**31) % 2**32 - 2**31).astype(np.int32)
    for r in range(2):
        with np.load(f"{runs['p']['sums']}.{r}.npz") as z:
            assert z["in_place"].dtype == z["staged"].dtype == np.int32
            assert np.array_equal(z["in_place"], z["staged"])
            assert np.array_equal(z["in_place"], want)


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


@pytest.mark.parametrize("rank", [0, 1])
def test_stripes_and_counter_checkpoints_equal_on_both_routes(runs, rank):
    a, b = runs["p"]["in_place"], runs["p"]["staged"]
    assert _read(f"{a}.rk.{rank}", "rb") == _read(f"{b}.rk.{rank}", "rb")
    with np.load(f"{a}.rk.mctr.{rank}.npz") as x, np.load(f"{b}.rk.mctr.{rank}.npz") as y:
        assert bytes(x["fp"]) == bytes(y["fp"])
        assert x["rows"].dtype == y["rows"].dtype == np.int32
        assert x["rows"].shape == (COUNTER // 2,)
        assert np.array_equal(x["rows"], y["rows"])
        assert x["rows"].any()


def test_count_tables_equal_on_both_routes(runs):
    a, b = runs["p"]["in_place"], runs["p"]["staged"]
    with np.load(a + ".npz") as x, np.load(b + ".npz") as y:
        assert x.files == y.files
        for k in x.files:
            assert np.array_equal(x[k], y[k]), k
        assert x["table"].any()
    assert _read(a + ".dump.0") == _read(b + ".dump.0") != ""
    assert _read(a + ".dump.1") == _read(b + ".dump.1") == ""
