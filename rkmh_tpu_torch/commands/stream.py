"""`stream` / `classify` command — per-read MinHash classification.

Counterpart of ``rkmh_tpu/commands/stream.py`` (plain file path,
:428-645, with -M and -I).  Output lines are byte-identical to
``rkmh-tpu stream`` (rkmh.cpp:891-893):

    ref \\t read \\t max_shared \\t sketch_size[FAIL:DEPTH] \\t [FAIL:MATCHES] \\t [FAIL:DIFF]

-I sketches the references from the k-mers counted at most max_samples
times over the panel; -M first counts every read k-mer in one pass over
the input, then classifies in a second pass with the k-mers counted
below min_kmer_occ dropped.  Both counters live on the device.  A batch
whose reads are contiguous rows of a natively parsed chunk is formatted
as one block by the native formatter (``rkmh_format_lines``), the rest
line by line (``format_lines_host``), as rkmh-tpu does
(rkmh_tpu/commands/stream.py:106-200, 612-630).  -i with
-f files logs that it is ignored and classifies the files, as rkmh-tpu
does (rkmh_tpu/commands/stream.py:481-488; rkmh's -i is dead).
--ref-sketches FILE (-R) takes the panel from a sketch file (``hash -o``,
sourmash or ``mash info -d``) in place of hashing -r files
(:500-504).  With -o FILE --resume, FILE's complete lines count the reads
already classified; a torn last line is cut, those reads are skipped after
the -M counter pass, which still counts every read, and the rest is
appended (:441-470, ``commands/recovery``).  -i without -f classifies
stdin as it arrives (``_run_stdin``, :315-425): a reader thread parses
records into a bounded queue, batches go to the device as they fill (or,
when the input stalls, as they are), and each batch's lines are written
and flushed once its result lands; with -M the stream is buffered and run
in two passes (:489-498).  ``--devices N [--tp T]`` runs the step over a
(dp, tp) grid of devices (``_ShardedClassify``, :242-305, :518-543): the
reads dp-sharded, the panel tp-sharded, the -M counter dp-sharded, the
output byte-identical; a geometry that cannot apply logs rkmh-tpu's line
and runs on one device.  ``--dist-procs N --dist-rank R
--dist-coordinator HOST:PORT`` (or rkmh-tpu's ``JAX_*`` variables) runs
one rank of a multi-process drain (``commands/dist_stream.py``, :431-439),
each rank writing its stripe of the output.
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
    DEFAULT_COUNTER_SIZE,
    ChunkedPipeline,
    LinesChunk,
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
from rkmh_tpu_torch.commands.recovery import count_complete_lines, fail_after_chunks, skip_reads
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from rkmh_tpu_torch.io.fastx import iter_fastx
from rkmh_tpu_torch.io.native import format_lines_block
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.observability import count, traced
from rkmh_tpu_torch.parallel import distributed

# the most lines dispatched but not yet written at once in the last -i run
# (at most 3 batches: the bound on what a live stream holds back)
last_peak_buffered_lines = 0


@dataclass
class StreamConfig:
    ref_files: list = field(default_factory=list)
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    sketch_size: int = DEFAULT_SKETCH
    min_kmer_occ: int = -1       # -M: read k-mer depth filter when >= 0
    min_matches: int = -1        # -N
    min_diff: int = 0            # -D
    max_samples: int | None = None  # -I: informative reference k-mers
    counter_size: int = DEFAULT_COUNTER_SIZE  # slots of each -M/-I counter
    batch_size: int = 0          # 0 = auto (16384 on cuda, 2048 on cpu)
    chunk_reads: int = 0         # streaming window; 0 = default (65536)
    ref_sketches: str = ""       # --ref-sketches / -R: panel from a sketch file
    out_file: str = ""           # -o: write here instead of stdout
    resume: bool = False         # --resume: go on with a partial -o file
    in_stream: bool = False      # -i: classify stdin (ignored with -f)
    devices: int = 0             # --devices: a (dp, tp) grid of N devices; 0 = one device
    tp: int = 1                  # --tp: panel shards (devices = dp * tp)
    device: str = DEFAULT_DEVICE
    mesh_devices: tuple | None = None  # the devices --devices takes (None: the visible ones)
    dist_coordinator: str = ""   # --dist-coordinator host:port
    dist_procs: int = 0          # --dist-procs: the number of processes
    dist_rank: int = -1          # --dist-rank: this process's rank


# the 8 possible "\t<sketch>[FAIL:DEPTH]\t[FAIL:MATCHES]\t[FAIL:DIFF]\n"
# line tails, indexed by flag bits diff_ok | depth_fail<<1 | match_fail<<2
def _tail_table(sketch_size: int):
    tails = []
    for f in range(8):
        diff_ok, depth, match = f & 1, f & 2, f & 4
        tails.append(
            f"\t{sketch_size}{'FAIL:DEPTH' if depth else ''}\t"
            f"{'FAIL:MATCHES' if match else ''}\t"
            f"{'' if diff_ok else 'FAIL:DIFF'}\n"
        )
    return tails


def format_lines_host(ref_keys, names, arr, sketch_size) -> list[str]:
    """One output line per read of a host [3, B] result array (best,
    shared, flags)."""
    best, shared, flags = (a.tolist() for a in arr)
    tails = _tail_table(sketch_size)
    return [
        f"{ref_keys[b]}\t{n}\t{c}{tails[f]}"
        for b, n, c, f in zip(best, names, shared, flags)
    ]


class _NativeFormatCtx:
    """The reference keys and the 8 line tails as blobs, made once a run
    for the native block formatter."""

    __slots__ = ("ref_blob", "ref_offs", "tails_blob", "tail_offs")

    def __init__(self, ref_keys, sketch_size: int):
        keys = [k.encode() for k in ref_keys]
        self.ref_blob = b"".join(keys)
        self.ref_offs = np.cumsum([0] + [len(k) for k in keys], dtype=np.int64)
        tails = [t.encode() for t in _tail_table(sketch_size)]
        self.tails_blob = b"".join(tails)
        self.tail_offs = np.cumsum([0] + [len(t) for t in tails], dtype=np.int64)

    def format_block(self, arr, rows, names) -> str:
        """The lines of a fetched [3, n] result for the chunk rows ``rows``,
        read from the name blob of ``names`` (a NamesOnly with a blob)."""
        return format_lines_block(arr, rows, names.blob, names.offs, self.ref_blob,
                                  self.ref_offs, self.tails_blob, self.tail_offs).decode()


# -i liveness: how long the consumer waits for input before it (a) writes
# the lines of a batch already dispatched, (b) dispatches a partial batch
_STDIN_DRAIN_IDLE_S = 0.05
_STDIN_FLUSH_IDLE_S = 0.25
_IDLE = object()
_EOF = object()


def _run_stdin(cfg: StreamConfig, out, panel, batch_size: int, step, stdin) -> int:
    """stream -i: classify a stream (``stdin``, or the process's stdin)
    with low latency, byte-identical to file mode.  A reader thread parses
    records into a queue of at most 4 batches; the consumer fills batches,
    keeps up to 3 in flight on the device and writes and flushes each
    batch's lines as its result is fetched.  On a source that stalls
    (``tail -f``) it first writes the results of dispatched batches, then
    dispatches the partial batch, rather than wait for more input.  A
    parse error in the reader thread is raised here, after the lines of
    the whole batches before it (as in rkmh-tpu, the partial batch is
    dropped)."""
    global last_peak_buffered_lines
    last_peak_buffered_lines = 0
    src = stdin if stdin is not None else "-"
    q: queue.Queue = queue.Queue(maxsize=4 * batch_size)

    def read():
        try:
            for rec in iter_fastx(src):
                q.put(rec)
            q.put(_EOF)
        except BaseException as e:  # raised by the consumer, not taken for EOF
            q.put(e)

    threading.Thread(target=read, name="rkmh-stdin", daemon=True).start()
    pending: deque = deque()  # (records, device result) in input order

    def emit():
        recs, res = pending.popleft()
        out.write("".join(format_lines_host(panel.keys, [r.name for r in recs],
                                            res.cpu().numpy(), cfg.sketch_size)))
        out.flush()
        count("reads", len(recs))  # rkmh_tpu/commands/stream.py:367-368
        count("bp", sum(len(r.seq) for r in recs))

    def dispatch(recs):
        global last_peak_buffered_lines
        codes, _ = encode_seqs([r.seq for r in recs])
        pending.append((recs, step(codes)))
        last_peak_buffered_lines = max(last_peak_buffered_lines,
                                       sum(len(r) for r, _ in pending))

    def get(timeout):
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            return _IDLE

    batch: list = []
    err = None
    while True:
        rec = get(_STDIN_DRAIN_IDLE_S) if (pending or batch) else q.get()
        if rec is _IDLE:
            if pending:  # input idle: first write what has been classified
                emit()
                continue
            rec = get(_STDIN_FLUSH_IDLE_S)  # then, still idle, the partial batch
            if rec is _IDLE:
                dispatch(batch)
                batch = []
                continue
        if rec is _EOF:
            break
        if isinstance(rec, BaseException):
            err = rec
            break
        batch.append(rec)
        if len(batch) >= batch_size:
            dispatch(batch)
            batch = []
            if len(pending) > 2:
                emit()
    if batch and err is None:
        dispatch(batch)
    while pending:
        emit()
    if err is not None:
        raise err
    return 0


def _validate_devices(cfg: StreamConfig, num_refs: int, n_visible: int) -> str | None:
    """Why --devices cannot apply: "unset" without it (--tp alone runs on
    one device, silently), None when it can."""
    if cfg.devices <= 1:
        return "unset"
    return sharded_geometry_reason(cfg.devices, cfg.tp, num_refs, n_visible,
                                   cfg.min_kmer_occ, cfg.counter_size)


@traced("stream")
def run(cfg: StreamConfig, out=None, stdin=None) -> int:
    """``stdin``: the stream -i reads (a binary file object; default the
    process's stdin)."""
    if distributed.requested(cfg.dist_procs, cfg.dist_coordinator):
        from rkmh_tpu_torch.commands.dist_stream import run_distributed

        return run_distributed(cfg, out)
    if cfg.resume and not cfg.out_file:
        log("stream --resume requires -o <file> (resume state is the "
            "partial output itself); refusing to reclassify to stdout")
        return 1
    if cfg.resume and cfg.in_stream:
        log("stream --resume cannot combine with -i: a stream is not "
            "re-readable, so skipped reads cannot be matched up")
        return 1
    if out is None and cfg.out_file:
        resume_skip, mode = 0, "w"
        if cfg.resume and os.path.exists(cfg.out_file):
            resume_skip, mode = count_complete_lines(cfg.out_file), "a"
            log(f"Resuming: {resume_skip} reads already classified in {cfg.out_file}")
        with open(cfg.out_file, mode) as fh:
            return _run(cfg, fh, resume_skip, stdin)
    return _run(cfg, out or sys.stdout, stdin=stdin)


def _run(cfg: StreamConfig, out, resume_skip: int = 0, stdin=None) -> int:
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    chunk_reads = resolve_chunk_reads(cfg.chunk_reads)
    ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")
    read_files, in_stream = cfg.read_files, cfg.in_stream
    if in_stream and read_files:
        log("stream -i ignored: -f inputs were given (rkmh classified the "
            "files here too — its -i is dead); classifying the files")
        in_stream = False
    if in_stream and cfg.min_kmer_occ >= 0:
        # -M counts every read before any is classified: the stream is
        # buffered and read twice (two_pass_chunks), its lines written at EOF
        log("stream -i with -M: global depth counting buffers the stream "
            "(two passes); output is emitted after EOF.")
        read_files, in_stream = [stdin if stdin is not None else "-"], False

    panel = load_or_build_panel(cfg.ref_files, cfg.ref_sketches, ks, cfg.sketch_size, device,
                                max_samples=cfg.max_samples, counter_size=cfg.counter_size)
    candidates = mesh_candidates(device, cfg.mesh_devices)
    reason = _validate_devices(cfg, panel.num_refs, len(candidates))
    if cfg.devices > 1 and reason not in (None, "unset"):
        log(f"stream --devices ignored ({reason}); running single-device")
    sharded = (ShardedCtx(panel, ks, cfg.devices, cfg.tp, cfg.counter_size, batch_size,
                          candidates) if reason is None else None)
    counter = None

    def step(codes: np.ndarray) -> torch.Tensor:
        if sharded is not None:
            return sharded.step(codes, cfg.sketch_size, cfg.min_diff, cfg.min_matches,
                                cfg.min_kmer_occ)
        return engine.classify_codes_table(to_device(codes, device), panel, ks,
                                           cfg.sketch_size, cfg.min_diff, cfg.min_matches,
                                           counter, cfg.min_kmer_occ)

    if in_stream:
        return _run_stdin(cfg, out, panel, batch_size, step, stdin)
    if cfg.min_kmer_occ >= 0:
        pass1, pass2 = two_pass_chunks(read_files, chunk_reads)
        if sharded is not None:  # the counter itself shards over dp (parallel/ep.py)
            sharded.build_counter(pass1)
        else:
            counter = count_read_kmers(pass1, ks, cfg.counter_size, batch_size, device).table
        chunks = pass2()
    else:
        chunks = iter_packed_chunks(read_files, chunk_reads)
    if resume_skip:  # the -M counter pass above counted every read
        chunks = skip_reads(chunks, resume_skip)

    def dispatch(st, rows, codes, lens):
        return rows, step(codes)

    def fetch(results):
        return [r.cpu().numpy() for r in results]

    fmt = _NativeFormatCtx(panel.keys, cfg.sketch_size)

    def on_result(st, rows, arr):
        if st.chunk.blob is not None and rows[-1] - rows[0] == len(rows) - 1:
            st.parts.append((int(rows[0]), fmt.format_block(arr, rows, st.chunk)))
        else:
            st.parts.append((rows.tolist(), format_lines_host(
                panel.keys, [st.chunk.names[i] for i in rows], arr, cfg.sketch_size)))
        st.filled += len(rows)

    pipeline = ChunkedPipeline(on_result=on_result,
                               emit=lambda st: out.write(st.render()), fetch=fetch,
                               fail_after=fail_after_chunks())
    pipeline.run(chunks, make_state=LinesChunk, dispatch=dispatch, batch_size=batch_size)
    return 0
