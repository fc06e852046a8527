"""`filter` command — emit the reads that pass the classification filters.

Counterpart of ``rkmh_tpu/commands/filter_cmd.py:65-346`` (rkmh
main_filter, rkmh.cpp:996-1424) on one device.  Output is byte-identical
to ``rkmh-tpu filter``:

* file mode (``-f``): each read that passes the depth, match and diff
  filters is written again as a 4-line record with a ``>`` header over a
  FASTQ body, as rkmh writes it (rkmh.cpp:1298-1302); a FASTA read gets
  ``I`` x its length as qualities.  The files are read by the native
  parser, whose chunks give the records' sequences and qualities;
* ``-i`` mode: reads from stdin (or the file object given to ``run``),
  parsed by the Python parser as rkmh-tpu does, are classified a batch at
  a time, each reported as ``Sample: <name>\\tResult:
  <ref>\\t<shared>\\t<union>\\t[FAIL:DEPTH]\\t[FAIL:MATCHES]\\t[FAIL:DIFF]``
  (rkmh.cpp:1397-1399); a reader thread fills a bounded queue;
* with both ``-f`` and ``-i``, the files run first, then the stream;
* with ``-o FILE``, ``FILE.progress`` holds (reads done, output bytes),
  saved after each file-mode chunk's records are flushed
  (``commands/recovery.Progress``, rkmh_tpu/commands/filter_cmd.py:275-281),
  byte-identical to rkmh-tpu's; ``--resume`` (of either package) truncates
  FILE to the sidecar's bytes, skips its reads after the -M counter pass,
  which still counts every read, and appends the rest (refused, as
  rkmh-tpu refuses, without a readable sidecar or with FILE shorter than
  it says);
* ``--ref-sketches FILE`` (``-R``) takes the panel from a sketch file in
  place of hashing the -r files (rkmh_tpu/commands/filter_cmd.py:137-141).

Classification uses the filter argmax (``engine.argmax_filter``: a read
that matches nothing gets reference "" and fails the diff filter).  -I
counts each k-mer once per reference (unlike stream -I); -M counts every
read k-mer of the ``-f`` files in a first pass, so with -M and no ``-f``
the counter stays empty and every streamed read fails, as in rkmh.
``--devices N [--tp T]`` runs the step over a (dp, tp) grid of devices
(rkmh_tpu/commands/filter_cmd.py:158-176, 226-240: ``commands.common
.ShardedCtx``), in file mode and -i, with the -M counter dp-sharded; pad
rows have keep 0 and fall off; a geometry that cannot apply logs rkmh-tpu's
line and runs on one device.  ``--dist-*`` runs one rank of a
multi-process drain (``commands/dist_stream.run_distributed_filter``;
rkmh_tpu/commands/filter_cmd.py:68-75): its passing records and an
``.idx`` of their count for every global batch.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import (
    DEFAULT_KMER,
    DEFAULT_SKETCH,
    ChunkState,
    ChunkedPipeline,
    ShardedCtx,
    count_read_kmers,
    iter_packed_chunks,
    load_or_build_panel,
    log,
    mesh_candidates,
    resolve_batch_size,
    resolve_chunk_reads,
    sharded_geometry_reason,
    two_pass_chunks,
)
from rkmh_tpu_torch.commands.recovery import Progress, fail_after_chunks, skip_reads
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from rkmh_tpu_torch.io.fastx import iter_batches
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.observability import traced
from rkmh_tpu_torch.parallel import distributed

DEFAULT_COUNTER_SIZE = 10_000_000  # rkmh.cpp:1187-1188
# results fetched per host sync: smaller than stream's because every
# pending batch pins its whole chunk (filter re-emits sequences and
# qualities), as in the JAX package (filter_cmd.py:287-291)
FETCH_GROUP = 8
STREAM_QUEUE = 4     # parsed -i batches the reader thread may run ahead
STREAM_IN_FLIGHT = 2  # -i batches dispatched before the oldest is written


@dataclass
class FilterConfig:
    ref_files: list = field(default_factory=list)
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    sketch_size: int = DEFAULT_SKETCH
    min_kmer_occ: int = -1          # -M: read k-mer depth filter when >= 0
    min_matches: int = -1           # -N
    min_diff: int = 0               # -D
    max_samples: int | None = None  # -I: informative reference k-mers
    in_stream: bool = False         # -i: classify reads from stdin
    counter_size: int = DEFAULT_COUNTER_SIZE
    batch_size: int = 0             # 0 = auto (16384 on cuda, 2048 on cpu)
    chunk_reads: int = 0            # streaming window; 0 = default (65536)
    ref_sketches: str = ""          # --ref-sketches / -R: panel from a sketch file
    out_file: str = ""              # -o: write here instead of stdout
    resume: bool = False            # --resume: go on with a partial -o file
    devices: int = 0                # --devices: a (dp, tp) grid of N devices; 0 = one device
    tp: int = 1                     # --tp: panel shards (devices = dp * tp)
    device: str = DEFAULT_DEVICE
    mesh_devices: tuple | None = None  # the devices --devices takes (None: the visible ones)
    dist_coordinator: str = ""      # --dist-coordinator host:port
    dist_procs: int = 0             # --dist-procs: the number of processes
    dist_rank: int = -1             # --dist-rank: this process's rank


@traced("filter")
def run(cfg: FilterConfig, out=None, stdin=None, stats: dict | None = None) -> int:
    """Run filter; ``stdin`` is the -i source (a binary file object; the
    process's stdin when None).  ``stats``, when given, receives the
    number of file-mode reads run (``reads``) and of those kept (``kept``);
    a --dist-* rank leaves it empty."""
    if distributed.requested(cfg.dist_procs, cfg.dist_coordinator):
        from rkmh_tpu_torch.commands.dist_stream import run_distributed_filter

        return run_distributed_filter(cfg, out)
    if cfg.resume and not cfg.out_file:
        log("filter --resume requires -o <file>; refusing to re-filter "
            "to stdout")
        return 1
    if cfg.resume and cfg.in_stream:
        log("filter --resume cannot combine with -i: a stream is not "
            "re-readable, so skipped reads cannot be matched up")
        return 1
    if out is None and cfg.out_file:
        progress = Progress(cfg.out_file)
        resume_skip, mode = 0, "w"
        if cfg.resume and os.path.exists(cfg.out_file):
            state = progress.load()
            if state is None:
                log(f"filter --resume: no readable progress sidecar at "
                    f"{progress.path}; cannot infer how many reads the "
                    f"partial output covers — rerun without --resume")
                return 1
            resume_skip, out_bytes = state
            if os.path.getsize(cfg.out_file) < out_bytes:
                log(f"filter --resume: {cfg.out_file} is shorter than the "
                    f"{out_bytes} bytes its progress sidecar covers — the "
                    f"output was modified since the run; rerun without "
                    f"--resume")
                return 1
            with open(cfg.out_file, "r+b") as fh:
                fh.truncate(out_bytes)  # drop the interrupted chunk's tail
            log(f"Resuming: {resume_skip} reads already filtered into "
                f"{cfg.out_file}")
            mode = "a"
        with open(cfg.out_file, mode) as fh:
            return _run(cfg, fh, stdin, stats, progress, resume_skip)
    return _run(cfg, out or sys.stdout, stdin, stats)


def _record(name: str, seq: bytes, qual: bytes | None) -> str:
    qual = qual if qual is not None else b"I" * len(seq)
    return f">{name}\n{seq.decode()}\n+\n{qual.decode()}\n"


def _stream_line(ref_keys, name: str, best: int, shared: int, union: int, f: int) -> str:
    return (f"Sample: {name}\tResult: {ref_keys[best] if best >= 0 else ''}\t{shared}\t"
            f"{union}\t{'FAIL:DEPTH' if f & 1 else ''}\t{'FAIL:MATCHES' if f & 2 else ''}\t"
            f"{'' if f & 4 else 'FAIL:DIFF'}\n")


class _Chunk(ChunkState):
    __slots__ = ("chunk", "keep")

    def __init__(self, chunk):
        super().__init__(len(chunk))
        self.chunk = chunk
        self.keep = np.zeros(len(chunk), dtype=bool)


def _run(cfg: FilterConfig, out, stdin, stats, progress: Progress | None = None,
         resume_skip: int = 0) -> int:
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    chunk_reads = resolve_chunk_reads(cfg.chunk_reads)
    ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")

    panel = load_or_build_panel(cfg.ref_files, cfg.ref_sketches, ks, cfg.sketch_size, device,
                                max_samples=cfg.max_samples, counter_size=cfg.counter_size,
                                distinct_counter=True)
    # decided before the -M pass: with --devices the counter shards over dp
    sharded = None
    if cfg.devices > 1:
        candidates = mesh_candidates(device, cfg.mesh_devices)
        reason = sharded_geometry_reason(cfg.devices, cfg.tp, panel.num_refs, len(candidates),
                                         cfg.min_kmer_occ, cfg.counter_size)
        if reason is not None:
            log(f"filter --devices ignored ({reason}); running single-device")
        else:
            sharded = ShardedCtx(panel, ks, cfg.devices, cfg.tp, cfg.counter_size, batch_size,
                                 candidates)
    counter = None
    chunks = None
    if cfg.min_kmer_occ >= 0:
        # the counter exists, possibly empty, whenever -M is given
        pass1, pass2 = two_pass_chunks(cfg.read_files, chunk_reads)
        if sharded is not None:
            sharded.build_counter(pass1)
        else:
            counter = count_read_kmers(pass1, ks, cfg.counter_size, batch_size, device).table
        chunks = pass2()

    def classify(codes: np.ndarray) -> torch.Tensor:
        if sharded is not None:
            return sharded.step(codes, cfg.sketch_size, cfg.min_diff, cfg.min_matches,
                                cfg.min_kmer_occ, filter_mode=True)
        return engine.filter_codes_table(to_device(codes, device), panel, ks, cfg.sketch_size,
                                         cfg.min_diff, cfg.min_matches, counter,
                                         cfg.min_kmer_occ)

    def fetch(results):
        return [r.cpu().numpy() for r in results]

    if cfg.read_files:
        n_reads = n_kept = 0

        def emit(st):
            nonlocal n_reads, n_kept
            c = st.chunk
            kept = np.nonzero(st.keep)[0]
            out.write("".join(_record(c.names[i], c.seqs[i], c.quals[i]) for i in kept))
            n_reads += st.n
            n_kept += len(kept)
            if progress is not None:
                # flush first: everything the sidecar points at is in the file
                out.flush()
                progress.save(resume_skip + n_reads, os.fstat(out.fileno()).st_size)

        def on_result(st, rows, arr):
            st.keep[rows] = arr[3].astype(bool)
            st.filled += len(rows)

        pipeline = ChunkedPipeline(on_result=on_result, emit=emit, fetch=fetch,
                                   group=FETCH_GROUP, fail_after=fail_after_chunks())
        if chunks is None:
            chunks = iter_packed_chunks(cfg.read_files, chunk_reads)
        if resume_skip:  # the -M counter pass above counted every read
            chunks = skip_reads(chunks, resume_skip)
        pipeline.run(chunks, make_state=_Chunk, dispatch=lambda st, rows, codes, lens:
                     (rows, classify(codes)), batch_size=batch_size)
        if stats is not None:
            stats.update(reads=n_reads, kept=n_kept)

    if cfg.in_stream:
        _run_stream(stdin if stdin is not None else "-", batch_size, classify, fetch,
                    panel.keys, out)
    return 0


def _run_stream(src, batch_size: int, classify, fetch, ref_keys, out) -> None:
    """-i: a reader thread parses batches into a bounded queue while this
    thread encodes, dispatches and writes them, STREAM_IN_FLIGHT batches
    behind (rkmh.cpp:1329-1414).  A parse error is raised here."""
    q: queue.Queue = queue.Queue(maxsize=STREAM_QUEUE)
    failure = []

    def reader():
        try:
            for recs in iter_batches(src, batch_size):
                q.put(recs)
        except Exception as e:  # re-raised by the consumer below
            failure.append(e)
        finally:
            q.put(None)

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()

    def write(recs, res):
        (arr,) = fetch([res])
        best, shared, union, _, flags = (a.tolist() for a in arr)
        out.write("".join(_stream_line(ref_keys, r.name, best[i], shared[i], union[i],
                                       flags[i]) for i, r in enumerate(recs)))

    pending = deque()
    while (recs := q.get()) is not None:
        codes, _ = encode_seqs([r.seq for r in recs])
        pending.append((recs, classify(codes)))
        if len(pending) > STREAM_IN_FLIGHT:
            write(*pending.popleft())
    while pending:
        write(*pending.popleft())
    thread.join()
    if failure:
        raise failure[0]
