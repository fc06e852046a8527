"""Several processes: a ``torch.distributed`` process group and per-rank read shards.

Counterpart of ``rkmh_tpu/parallel/distributed.py:33-79``.  rkmh-tpu
brings up ``jax.distributed`` and one global mesh over every process's
devices; the port brings up a ``torch.distributed`` group, and each rank
(process) works on its own grid of local devices (its share of rkmh-tpu's
``global_mesh``: ``commands/common.mesh_candidates``).
``commands/dist_stream.py`` drives the ranks.

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
* The backend is gloo, on the host.  A machine with one card puts every
  rank on ``cuda:0``, and NCCL refuses two ranks of one group on one
  device.  No kernel moves to the host for it: each rank runs its kernels
  on its own card, and every collective of ``dist_stream`` carries host
  data (the ints of ``allmin`` / ``allmax``, the -M counter's one
  reduction a run, the checkpoint's blocks).  ``--device cuda`` without a
  card still raises.  A group on NCCL, for hosts with one card per rank,
  has not run (ROADMAP).
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 300


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
