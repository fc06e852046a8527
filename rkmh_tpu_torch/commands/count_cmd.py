"""`count` command — every k-mer of every read into a lossy counter table.

Counterpart of ``rkmh_tpu/commands/count_cmd.py`` (``run`` :52) on one
device: rkmh's ``HASHTCounter(640000)`` (rkmh.cpp:2268-2360), the same
``hash % size`` table, collisions and hash-0 windows included.  Output is
rkmh-tpu's:

* stderr — one summary line (windows counted on the host from the read
  lengths, reads, table size, occupied slots); stdout stays empty;
* ``-o table.npz`` — the table, its size and the k values
  (``np.savez_compressed``; ``convert.counter_from_npz`` loads it back);
* ``--dump`` — ``slot\\tcount`` for every occupied slot, on stdout.

The counting is the -M counter pass of the other commands
(``common.count_read_kmers``: K1, then K6 with the window mask derived in
the kernel), and the table comes back in one device-to-host copy.
``--devices N`` (``commands.common.DpCtx``, rkmh_tpu/commands/
count_cmd.py:69-73) hashes each of a batch's N row slices on its own
device and adds them into the one table (addition commutes: the same
bits).  ``--dist-*`` runs one rank of a multi-process count
(``commands/dist_stream.run_distributed_count``, rkmh_tpu/commands/
count_cmd.py:55-59).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from rkmh_tpu_torch.commands.common import (
    DEFAULT_KMER,
    DpCtx,
    count_read_kmers,
    iter_packed_chunks,
    log,
    resolve_batch_size,
    resolve_chunk_reads,
)
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from rkmh_tpu_torch.observability import traced
from rkmh_tpu_torch.parallel import distributed

DEFAULT_COUNTER_SIZE = 640_000  # rkmh.cpp:2322


@dataclass
class CountConfig:
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    counter_size: int = DEFAULT_COUNTER_SIZE
    batch_size: int = 0             # 0 = auto (16384 on cuda, 2048 on cpu)
    out_file: str = ""              # -o: save the table as npz
    dump: bool = False              # --dump: print the occupied slots
    chunk_reads: int = 0            # streaming window; 0 = default (65536)
    devices: int = 0                # --devices: hash over N devices (dp); 0 = one device
    device: str = DEFAULT_DEVICE
    mesh_devices: tuple | None = None  # the devices --devices takes (None: the visible ones)
    dist_coordinator: str = ""      # --dist-coordinator host:port
    dist_procs: int = 0             # --dist-procs: the number of processes
    dist_rank: int = -1             # --dist-rank: this process's rank


@traced("count")
def run(cfg: CountConfig, out=None, stats: dict | None = None) -> int:
    """Run count; ``stats``, when given, receives the K6 route the counter
    took (``binned``: True, False, or None where no call went through the
    bins)."""
    if distributed.requested(cfg.dist_procs, cfg.dist_coordinator):
        from rkmh_tpu_torch.commands.dist_stream import run_distributed_count

        return run_distributed_count(cfg, out)
    out = out or sys.stdout
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("Using default kmer size of 16.")
    dpc = DpCtx.maybe(cfg.devices, device, cfg.mesh_devices)
    if dpc is not None:
        batch_size = dpc.round_batch(batch_size)

    total_reads = total_kmers = 0

    def tallied(chunks):
        # the windows are a host-side function of the lengths: no device read
        nonlocal total_reads, total_kmers
        for chunk in chunks:
            total_reads += len(chunk)
            lens = chunk.lens.astype(np.int64)
            total_kmers += int(sum(np.maximum(lens - (k - 1), 0).sum() for k in ks))
            yield chunk

    counter = count_read_kmers(
        tallied(iter_packed_chunks(cfg.read_files, resolve_chunk_reads(cfg.chunk_reads))),
        ks, cfg.counter_size, batch_size, device, dpc)
    if stats is not None:
        stats["binned"] = counter.binned
    table = counter.to_numpy()
    occupied = int((table > 0).sum())
    log(f"Counted {total_kmers} kmers from {total_reads} reads into "
        f"{cfg.counter_size}-slot table ({occupied} slots occupied).")
    write_table(cfg, table, ks, out)
    return 0


def write_table(cfg: CountConfig, table: np.ndarray, ks, out) -> None:
    """``-o`` (the npz) and ``--dump`` (a line for each occupied slot)."""
    if cfg.out_file:
        np.savez_compressed(cfg.out_file, table=table, size=cfg.counter_size,
                            ks=np.asarray(ks))
        log(f"Saved counter table to {cfg.out_file}")
    if cfg.dump:
        (nz,) = np.nonzero(table)
        out.write("".join(f"{slot}\t{count}\n"
                          for slot, count in zip(nz.tolist(), table[nz].tolist())))
