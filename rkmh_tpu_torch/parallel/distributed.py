"""Several processes: a ``torch.distributed`` process group and per-rank read shards.

Counterpart of ``rkmh_tpu/parallel/distributed.py:33-79``.  rkmh-tpu
brings up ``jax.distributed`` and one global mesh over every process's
devices; the port brings up a ``torch.distributed`` group, and each rank
(process) works on its own grid of local devices (its share of rkmh-tpu's
``global_mesh``).  ``commands/dist_stream.py`` drives the ranks.

* A rank's devices (``rank_devices``): on CUDA, its share of its host's
  visible cards.  ``host_local_rank`` finds the rank's index among the
  ranks on its host, and their count L, from every rank's host name
  gathered in one collective at the join; with n visible cards, local
  rank l takes cards [l n / L, (l + 1) n / L) where L divides n, else
  card l mod n alone.  So four ranks on a host of four cards take one
  card each, and several ranks on a one-card machine share ``cuda:0``.
  The tests' ``mesh_devices`` seam, where given, wins.

* ``initialize`` reads the flags, or else the variables rkmh-tpu reads
  (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
  and is a no-op for one process without a coordinator, as rkmh-tpu's.
  The group's rendezvous is ``tcp://<coordinator>`` (rank 0 serves it),
  or a coordinator given as ``file://<path>``: a file on a filesystem
  every rank sees, which opens no socket for the rendezvous (the tests and
  ``chip_smoke.py`` use one).  Every wait, the rendezvous and each
  collective, ends after ``DEFAULT_TIMEOUT_S`` (300 s; ``timeout_s``) with
  an error, not after torch's default of 30 minutes, so a rank whose peer
  died fails instead of hanging.
* The backend is gloo, on the host.  Ranks that share a card (a machine
  with fewer cards than ranks) would be refused by NCCL, which takes one
  rank a device.  No kernel moves to the host for it: each rank runs its
  kernels on its own card, and every collective of ``dist_stream``
  carries host data (the ints of ``allmin`` / ``allmax``, each a
  ``dist.collective`` span: the wait on the slowest rank; the -M
  counter's one reduction a run; the checkpoint's blocks; the host
  names).  ``--device cuda`` without a card still raises.  A group on
  NCCL, for hosts with one card per rank, has not run (ROADMAP).
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch

from rkmh_tpu_torch.observability import span

DEFAULT_TIMEOUT_S = 300
HOST_NAME_BYTES = 256  # a host name's bytes in the gather (a DNS name has at most 253)


def requested(dist_procs: int, dist_coordinator: str) -> bool:
    """Whether a command takes its --dist-* drain: more than one process,
    a coordinator, or ``JAX_COORDINATOR_ADDRESS`` (as
    ``rkmh_tpu/commands/stream.py:431-433`` decides)."""
    return bool(dist_procs > 1 or dist_coordinator
                or os.environ.get("JAX_COORDINATOR_ADDRESS"))


def _settings(coordinator, num_processes, process_id):
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS") or None
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    return coordinator, num_processes, process_id


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up the gloo process group; False (nothing done) for one
    process without a coordinator.  A group already up with the same
    size and rank is kept (a process may run several drains); raises
    ValueError for settings that name no group (a coordinator without a
    process count or rank, or a count without a coordinator) or that
    differ from the group already up."""
    import torch.distributed as dist

    coordinator, num_processes, process_id = _settings(coordinator, num_processes, process_id)
    if num_processes in (None, 1) and coordinator is None:
        return False
    if num_processes is None:
        raise ValueError(f"--dist-coordinator {coordinator} needs --dist-procs "
                         "(or JAX_NUM_PROCESSES)")
    if coordinator is None:
        raise ValueError(f"--dist-procs {num_processes} needs --dist-coordinator host:port "
                         "(or JAX_COORDINATOR_ADDRESS)")
    if process_id is None:
        if num_processes != 1:
            raise ValueError(f"--dist-procs {num_processes} needs --dist-rank "
                             "(or JAX_PROCESS_ID)")
        process_id = 0
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--dist-rank {process_id} is not in [0, {num_processes})")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise ValueError(f"a process group of {dist.get_world_size()} (rank "
                             f"{dist.get_rank()}) is already up")
        return True
    init = coordinator if coordinator.startswith("file://") else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return True


def process_count() -> int:
    """Processes in the group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def host_read_shard(n_records: int, process_id: int | None = None,
                    num_processes: int | None = None) -> tuple[int, int]:
    """[start, stop) of the input this process reads: contiguous blocks,
    the remainder spread over the first processes
    (``rkmh_tpu/parallel/distributed.py:56-71``)."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    base, rem = divmod(n_records, n)
    start = pid * base + min(pid, rem)
    return start, start + base + (1 if pid < rem else 0)


def _reduce_int(value: int, op) -> int:
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64)
    with span("dist.collective"):
        dist.all_reduce(t, op=op)
    return int(t.item())


def allmin(value: int) -> int:
    """The minimum of a per-rank int over the group (itself without a
    group).  A collective: every rank must call it at the same point."""
    import torch.distributed as dist

    return _reduce_int(value, dist.ReduceOp.MIN) if process_count() > 1 else int(value)


def allmax(value: int) -> int:
    """The maximum of a per-rank int over the group (a collective)."""
    import torch.distributed as dist

    return _reduce_int(value, dist.ReduceOp.MAX) if process_count() > 1 else int(value)


def all_reduce_sum_(table: torch.Tensor) -> torch.Tensor:
    """Sum a host tensor over the group, in place (a collective)."""
    import torch.distributed as dist

    if process_count() > 1:
        dist.all_reduce(table, op=dist.ReduceOp.SUM)
    return table


def all_gather_blocks(block: np.ndarray) -> np.ndarray:
    """Every rank's equal-length block, concatenated in rank order (a
    collective)."""
    import torch.distributed as dist

    if process_count() == 1:
        return block
    mine = torch.from_numpy(np.ascontiguousarray(block))
    parts = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(parts, mine)
    return torch.cat(parts).numpy()


def host_local_rank() -> tuple[int, int]:
    """(this rank's index among the group's ranks on its host, their
    count): every rank's host name gathered in one collective, the ranks
    on a host in rank order; (0, 1) without a group."""
    me = socket.gethostname().encode()[:HOST_NAME_BYTES].ljust(HOST_NAME_BYTES, b"\0")
    names = all_gather_blocks(np.frombuffer(bytearray(me), dtype=np.uint8))
    names = names.reshape(-1, HOST_NAME_BYTES)
    same = np.flatnonzero((names == names[process_index()]).all(1))
    return int(np.searchsorted(same, process_index())), len(same)


def rank_devices(visible: list, local_rank: int, local_size: int) -> list:
    """The rank's share of its host's ``visible`` devices: where the
    host's ``local_size`` ranks divide them, an equal block each (local
    rank l takes [l n / L, (l + 1) n / L)); else device ``local_rank mod
    n`` alone, so ranks beyond the devices share them."""
    n = len(visible)
    if n % local_size == 0:
        per = n // local_size
        return list(visible[local_rank * per:(local_rank + 1) * per])
    return [visible[local_rank % n]]
