"""Every command over several processes (--dist-*).

Counterpart of ``rkmh_tpu/commands/dist_stream.py``: :53-132 (geometry,
resume watermark), :135-224 (the -M counter's checkpoint), :226-367 (the
rank's batches, read by seeking through ``io/input_index``), :402-878
(set-up, ``run_distributed``, ``run_distributed_filter``), :881-1025
(``run_distributed_hpv16``), :1037-1403 (the map drains: hash, count,
search), :1465-1677 (``run_distributed_call``, ``merge_outputs_call``)
and the merge tool, :1406-1462 and :1680-1733
(``rkmh-tpu-torch-dist-merge``).

Every rank runs the same command.  The geometry is rkmh-tpu's, so stripes,
``.dist.json``, ``.idx`` and ``.mctr`` files are byte for byte those of an
rkmh-tpu run of the same geometry, and either package's merge tool
reassembles them into one process's output:

* a counting pre-pass agrees on the input's N reads and pad length L
  (every rank reads the same files, so no collective is needed);
* dp = H * n_local / tp over H ranks of n_local devices each (tp = 1 for
  hash, count and search); the global batch B rounds up to a multiple of
  dp * H, and rank r owns rows [r * Bl, (r + 1) * Bl) of each global batch
  (Bl = B / H), which it reads alone (seeking to them through the input
  index) and works on its own grid of local devices (one device, or a
  (n_local / tp, tp) grid: ``ShardedCtx`` for stream and filter, ``DpCtx``
  for hash and search, ``ShardedHpv16Comb`` / ``ShardedHpv16Sorted`` for
  hpv16);
* a rank finds its local devices at the join (``_rank_devices``): on
  CUDA its share of its host's visible cards
  (``distributed.rank_devices`` of its host-local rank, found by one
  gather of the ranks' host names), the first of them its current device
  and the one its panel, counter and batches live on: four ranks on a
  host of four cards take one card each, two ranks of a host of eight take
  four each, and ranks on a one-card machine share ``cuda:0``.  The
  ``mesh_devices`` seam (the tests', ``chip_smoke.py``'s) wins where it
  is given; on the CPU a rank has the one CPU;
* rank r writes its rows, in global order, to ``<out>.<r>`` (stream,
  hpv16 and hash: one line a read); filter and search also write
  ``<out>.<r>.idx``, their records in every global batch; count sums the
  ranks' tables and rank 0 writes it; call splits each reference's
  positions in dp slices and rank r writes partial sections of its own.

Where the port departs from rkmh-tpu:

* rkmh-tpu runs one SPMD program over a global mesh, so every process
  dispatches every batch in lockstep, a batch of padding rows included.
  Here each rank is its own program: tp never spans ranks (rkmh-tpu
  refuses that too), so no step needs a collective, and a rank does not
  dispatch a batch it owns no real row of, nor one whose output a resumed
  stripe already holds.  The output does not change: an ``.idx`` still
  gets a line (``0``) for such a batch, and the --resume watermark keeps
  rkmh-tpu's arithmetic and its collective.  For the same reason an hpv16
  rank cuts its sorted rows at its own rows' window count, as one process
  does, where rkmh-tpu probes at the full width (the same bytes), and
  call scans no reference whose section a resumed stripe holds.
* The counters (-M, count).  rkmh-tpu holds [size / H] slots on each
  process and ``psum_scatter``s a full-size table each batch of the
  counting pass (``rkmh_tpu/parallel/ep.py:112-141``), then gathers
  queries and sums counts each batch of the classify pass (:69-85; count:
  one final gather).  Here each rank counts its own rows into the whole
  ``[size]`` int32 table (K1 + K6; over its grid's dp slot ranges with
  ``parallel/ep.ShardedCounter``), one ``all_reduce(SUM)`` on the host
  after the pass makes it the global counter (bit-equal: integer addition
  commutes), and each rank masks with K7 on its own devices; no collective
  runs per batch.  The price: ``size * 4`` bytes through gloo once a run
  (800 MB at stream's default 2e8 slots, 3.2 GB at hpv16's 8e8, 40 MB at
  filter's 1e7, 2.56 MB at count's 640,000) and the whole table on each
  rank's card, where rkmh-tpu holds 1 / H of it.
* The checkpoint ``<out>.mctr.<rank>.npz`` keeps rkmh-tpu's content (``fp``
  the same JSON, ``rows`` this rank's contiguous [size / H] block of the
  global table); a restore all-gathers the blocks.  rkmh-tpu's int64
  widening before the fetch (:160-167, a TPU transfer workaround) is not
  carried over.
* call: rkmh-tpu passes each slice's window halo over the mesh
  (``ppermute``); a rank here makes the halo of its first slice from the
  whole depth map it holds (``ShardedCallScan.scan``).
"""

from __future__ import annotations

import json
import os
import sys
from collections import deque

import numpy as np
import torch

from rkmh_tpu_torch.call_engine import call_scan_ref
from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import (
    DEFAULT_KMER,
    DpCtx,
    ShardedCtx,
    _rereadable,
    iter_packed_chunks,
    load_or_build_panel,
    load_packed,
    load_records,
    log,
    mesh_candidates,
    pad_rows,
    resolve_batch_size,
    resolve_chunk_reads,
    rows_in_order,
)
from rkmh_tpu_torch.commands.recovery import count_complete_lines
from rkmh_tpu_torch.device import resolve_device, to_device
from rkmh_tpu_torch.io.packing import PAD_CODE, bucket_length, encode_seqs
from rkmh_tpu_torch.observability import count, span
from rkmh_tpu_torch.ops.counter import HashCounter
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes, multi_k_window_hashes
from rkmh_tpu_torch.parallel import distributed
from rkmh_tpu_torch.parallel.ep import ShardedCounter
from rkmh_tpu_torch.parallel.mesh import ShardedCallScan, make_mesh

IN_FLIGHT = 3  # batches dispatched before the oldest one's output is written


def _rereadable_inputs(read_files) -> bool:
    """The drains read the input more than once (the counting pre-pass,
    the -M pass, the classify pass), so only plain paths qualify: stdin,
    FIFOs and file objects would be drained by the first pass."""
    return bool(read_files) and all(_rereadable(p) for p in read_files)


def _scan_input(read_files, chunk_reads):
    """The counting pre-pass: (N, max read length, per-file input index or
    None when a file cannot be indexed), answered from the index cache
    after the first run (``io/input_index.scan_or_index``)."""
    from rkmh_tpu_torch.io.input_index import scan_or_index

    n, maxlen, index = scan_or_index(read_files, chunk_reads)
    if any(e is None for e in index):
        index = None
    return n, maxlen, index


def _owned_block(b: int, B: int, Bl: int, rank: int) -> tuple[int, int]:
    """Global row range [lo, hi) of batch b owned by this rank."""
    lo = b * B + rank * Bl
    return lo, lo + Bl


def _owned_lines(b: int, B: int, Bl: int, rank: int, N: int) -> int:
    """Real rows (output lines of a one-line-per-read drain) this rank owns
    in batch b; the rows past N are padding."""
    lo, hi = _owned_block(b, B, Bl, rank)
    return max(0, min(hi, N) - lo)


def _allmin(value: int, H: int) -> int:
    """The minimum of a per-rank int over the ranks (H = 1: itself).  A
    collective: every rank calls it at the same point."""
    return int(value) if H <= 1 else distributed.allmin(value)


def _resume_watermark(skip_lines: int, N: int, B: int, Bl: int, rank: int,
                      H: int) -> tuple[int, int]:
    """A rank's resumed line count -> (start batch, lines still to skip):
    the start batch is the min over ranks of each rank's complete leading
    batches, the lines skipped the rank's overhang past it
    (``rkmh_tpu/commands/dist_stream.py:108-132``).  A collective."""
    n_batches = -(-N // B) if N else 0
    w, acc = 0, 0
    while w < n_batches:
        lb = _owned_lines(w, B, Bl, rank, N)
        if acc + lb > skip_lines:
            break
        acc += lb
        w += 1
    start = _allmin(w, H)
    lines_before = sum(_owned_lines(b, B, Bl, rank, N) for b in range(start))
    return start, skip_lines - lines_before


def _counter_ckpt_path(out_file: str, rank: int) -> str:
    return f"{out_file}.mctr.{rank}.npz"


def _counter_fingerprint(read_files, ks, size: int, dp: int, H: int, rank: int) -> str:
    """What the -M checkpoint of a rank depends on: the inputs, ks and size
    (the counter's value), and dp, H and rank (the block it holds); ""
    for an input that cannot be fingerprinted."""
    from rkmh_tpu_torch.io.input_index import _fingerprint

    try:
        files = [(os.fspath(p), *_fingerprint(p)) for p in read_files]
    except (OSError, TypeError):
        return ""
    return json.dumps({"v": 1, "files": files, "ks": list(ks),
                       "size": size, "dp": dp, "H": H, "rank": rank})


def _save_counter_ckpt(table: np.ndarray, out_file: str, fp: str, H: int, rank: int) -> None:
    """Write this rank's [size / H] block of the global counter ``table``
    (atomically; best effort), so that --resume can skip the counting pass
    (off with RKMH_TPU_MCTR_CKPT=0)."""
    if not fp or os.environ.get("RKMH_TPU_MCTR_CKPT", "1") == "0":
        return
    per = table.shape[0] // H
    path = _counter_ckpt_path(out_file, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, fp=np.frombuffer(fp.encode(), np.uint8),
                                rows=table[rank * per:(rank + 1) * per])
        os.replace(tmp, path)
    except OSError as e:
        log(f"dist rank {rank}: -M counter checkpoint skipped ({e})")
        try:
            os.remove(tmp)
        except OSError:
            pass


def _load_counter_ckpt(out_file: str, fp: str, size: int, H: int, rank: int):
    """The checkpointed global counter as a host [size] int32 array, or
    None.  Every rank must hold its block (a collective decides), since
    a rank that counts again needs every other rank's counts too."""
    rows = None
    if fp and os.environ.get("RKMH_TPU_MCTR_CKPT", "1") != "0":
        try:
            with np.load(_counter_ckpt_path(out_file, rank)) as z:
                if bytes(z["fp"]).decode() == fp:
                    got = z["rows"].astype(np.int32)
                    if got.shape == (size // H,):
                        rows = got
        except (OSError, KeyError, ValueError):
            rows = None
    if not _allmin(rows is not None, H):
        return None
    return distributed.all_gather_blocks(rows)


def _iter_owned_batches(read_files, chunk_reads, N, B, Bl, rank, L,
                        with_records: bool = False, index=None, start_batch: int = 0):
    """Yield (batch, codes [Bl, L], lens [Bl], names [Bl]) for every global
    batch from ``start_batch`` on: this rank's rows, the rows past N
    all-PAD with length 0 and name None (a prefix of real rows, then
    padding).  ``with_records`` adds each row's (name, seq, qual) (None for
    padding), which filter writes out.  With a complete input index the
    rank seeks to its rows (``_iter_owned_batches_indexed``); otherwise it
    parses the whole input and keeps its rows
    (``rkmh_tpu/commands/dist_stream.py:226-296``)."""
    if index is not None:
        yield from _iter_owned_batches_indexed(
            read_files, index, N, B, Bl, rank, L, with_records, start_batch)
        return
    n_batches = -(-N // B) if N else 0

    def fresh():
        bufs = [np.full((Bl, L), PAD_CODE, np.uint8), np.zeros(Bl, np.int32), [None] * Bl]
        if with_records:
            bufs.append([None] * Bl)
        return bufs

    b = 0
    bufs = fresh()
    r = 0  # global row of the chunk's first record
    for chunk in iter_packed_chunks(read_files, chunk_reads):
        ccodes = np.asarray(chunk.codes)
        clens = np.asarray(chunk.lens)
        cnames = None
        n = len(chunk)
        pos = 0
        while pos < n:
            g = r + pos
            while b < g // B:  # the batches before g are complete
                if b >= start_batch:
                    yield (b, *bufs)
                b += 1
                bufs = fresh()
            lo, hi = _owned_block(b, B, Bl, rank)
            seg_end = min(r + n, (b + 1) * B)
            s, e = max(g, lo), min(seg_end, hi)
            if s < e:
                if cnames is None:
                    cnames = chunk.names
                w = ccodes.shape[1]
                bufs[0][s - lo:e - lo, :w] = ccodes[s - r:e - r]
                bufs[1][s - lo:e - lo] = clens[s - r:e - r]
                bufs[2][s - lo:e - lo] = cnames[s - r:e - r]
                if with_records:
                    bufs[3][s - lo:e - lo] = list(zip(cnames[s - r:e - r],
                                                      chunk.seqs[s - r:e - r],
                                                      chunk.quals[s - r:e - r]))
            pos = seg_end - r
        r += n
    while b < n_batches:
        if b >= start_batch:
            yield (b, *bufs)
        b += 1
        bufs = fresh()


def _iter_owned_batches_indexed(read_files, index, N, B, Bl, rank, L,
                                with_records: bool = False, start_batch: int = 0):
    """``_iter_owned_batches`` over a complete input index: each batch's
    owned block is a known (file, record range), so the rank seeks the
    native stream there and parses only its ~Bl records; the batches
    before ``start_batch`` are never read
    (``rkmh_tpu/commands/dist_stream.py:299-367``)."""
    from rkmh_tpu_torch.io.native import FastxStream

    if not isinstance(read_files, (list, tuple)):
        read_files = [read_files]
    n_batches = -(-N // B) if N else 0
    bases = [0]  # the global row of each file's first record
    for _offs, flens in index:
        bases.append(bases[-1] + len(flens))
    streams: list = [None] * len(read_files)
    at_rec = [0] * len(read_files)  # the record each stream stands at
    try:
        for b in range(start_batch, n_batches):
            codes = np.full((Bl, L), PAD_CODE, np.uint8)
            lens = np.zeros(Bl, np.int32)
            names: list = [None] * Bl
            recs: list = [None] * Bl
            lo, hi = _owned_block(b, B, Bl, rank)
            hi = min(hi, N)
            for f, (offs, _flens) in enumerate(index):
                s, e = max(lo, bases[f]), min(hi, bases[f + 1])
                if s >= e:
                    continue
                ls, le = s - bases[f], e - bases[f]
                if streams[f] is None:
                    streams[f] = FastxStream(read_files[f])
                    at_rec[f] = 0
                if at_rec[f] != ls:
                    streams[f].seek(int(offs[ls]))
                chunk = streams[f].next_chunk(le - ls)
                if chunk is None or len(chunk) != le - ls:
                    from rkmh_tpu_torch.io.input_index import index_path

                    raise RuntimeError(
                        f"{read_files[f]} changed under its input index (wanted records "
                        f"[{ls}, {le}) at offset {int(offs[ls])}, got "
                        f"{0 if chunk is None else len(chunk)}) — delete "
                        f"{index_path(read_files[f])} and rerun")
                at_rec[f] = le
                w = chunk.codes.shape[1]
                codes[s - lo:e - lo, :w] = chunk.codes
                lens[s - lo:e - lo] = chunk.lens
                names[s - lo:e - lo] = chunk.names
                if with_records:
                    recs[s - lo:e - lo] = list(zip(chunk.names, chunk.seqs, chunk.quals))
            yield (b, codes, lens, names, recs) if with_records else (b, codes, lens, names)
    finally:
        for st in streams:
            if st is not None:
                st.close()


def _write_meta(out_file: str, B: int, H: int, fmt: str = "stream", extra: dict | None = None):
    """``<out>.dist.json``: the stripes' geometry and format, which the
    merge tool reads (every rank writes the same bytes, atomically)."""
    path = f"{out_file}.dist.json"
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"global_batch": B, "procs": H, "format": fmt, **(extra or {})}, fh)
    os.replace(tmp, path)


def _load_meta(out_file: str):
    """The ``.dist.json`` sidecar, or None (absent or unreadable)."""
    try:
        with open(f"{out_file}.dist.json") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _check_resume_geometry(cfg, B: int, H: int, stripe_exists: bool):
    """--resume needs the geometry the stripes were written with: a stripe
    without a readable sidecar, or a sidecar of another global batch or
    rank count, is refused (the skips would drop or repeat other reads).
    No stripe and no sidecar is a fresh start."""
    meta = _load_meta(cfg.out_file)
    if meta is None:
        if stripe_exists:
            raise RuntimeError(
                f"--resume needs the {cfg.out_file}.dist.json sidecar of "
                "the interrupted run to verify the stripe geometry, and "
                "it is missing or unreadable — rerun without --resume")
        return
    if (meta.get("global_batch"), meta.get("procs")) != (B, H):
        raise RuntimeError(
            f"--resume geometry mismatch: {cfg.out_file}.dist.json records "
            f"global_batch={meta.get('global_batch')} procs="
            f"{meta.get('procs')} but this run would use {B}/{H} — rerun "
            "with the original --batch-size/--dist-procs or without "
            "--resume")


def _open_rank_out(cfg, out, rank: int, H: int, B: int, fmt: str):
    """(output stream, close it, lines to skip): ``<out>.<rank>`` (``-o``
    itself for one process) and its sidecar; with --resume the stripe's
    complete lines (filter keeps its own count in its ``.idx``)."""
    if out is not None:
        return out, False, 0
    if cfg.out_file:
        path = f"{cfg.out_file}.{rank}" if H > 1 else cfg.out_file
        skip = 0
        if cfg.resume:
            _check_resume_geometry(cfg, B, H, os.path.exists(path))
        if cfg.resume and os.path.exists(path):
            if fmt not in ("filter", "search"):
                skip = count_complete_lines(path)
                log(f"dist rank {rank}: resuming, {skip} lines already landed in {path}")
            fh = open(path, "a")
        else:
            fh = open(path, "w")
        _write_meta(cfg.out_file, B, H, fmt)
        return fh, True, skip
    return sys.stdout, False, 0


def _truncate_to_lines(path: str, n_lines: int) -> int:
    """Cut a text file to its first n_lines lines; -> the lines kept
    (fewer: the file was shorter)."""
    with open(path, "r+b") as fh:
        off = kept = 0
        for _ in range(n_lines):
            line = fh.readline()
            if not line or not line.endswith(b"\n"):
                break
            off += len(line)
            kept += 1
        fh.truncate(off)
    return kept


class _DistCtx:
    """A rank's state for a drain: the group (H, rank), its local devices
    and grid (``mesh``: None for one device), the geometry and the input
    scan; a classify drain's panel and ``ShardedCtx``, and the -M counter."""

    __slots__ = ("H", "rank", "dp", "B", "Bl", "L", "N", "ks", "chunk_reads", "panel",
                 "index", "device", "local", "mesh", "dpc", "sharded", "counter")


def _new_counter(ctx: _DistCtx, cfg):
    """An empty whole-size counter of ``cfg.counter_size`` slots on the
    rank's devices (a ``ShardedCounter`` over the grid's dp slot ranges,
    or one ``HashCounter``); -> (counter, its device tables in slot order)."""
    if ctx.mesh is not None:
        counter = ShardedCounter(ctx.mesh, cfg.counter_size)
        tables = [o.table for o in counter.owners]
    else:
        counter = HashCounter(cfg.counter_size, ctx.device)
        tables = [counter.table]
    return counter, tables


def _count_rows(ctx: _DistCtx, cfg, counter) -> tuple[int, int]:
    """Count every window of this rank's rows (K1 + K6); -> (reads,
    windows) counted."""
    reads = windows = 0
    for b, codes, lens, _names in _iter_owned_batches(
            cfg.read_files, ctx.chunk_reads, ctx.N, ctx.B, ctx.Bl, ctx.rank, ctx.L,
            index=ctx.index):
        n = _owned_lines(b, ctx.B, ctx.Bl, ctx.rank, ctx.N)
        if not n:
            continue
        reads += n
        windows += int(sum(np.maximum(lens[:n].astype(np.int64) - (k - 1), 0).sum()
                           for k in ctx.ks))
        if isinstance(counter, ShardedCounter):
            counter.add_codes(*pad_rows(codes[:n], lens[:n], counter.mesh.dp), ctx.ks)
        else:
            counter.add_windows(multi_k_window_hashes(to_device(codes[:n], ctx.device), ctx.ks),
                                to_device(lens[:n], ctx.device, non_blocking=False), ctx.L,
                                ctx.ks)
    return reads, windows


def _fill(tables, host: torch.Tensor) -> None:
    """Copy a host [size] table into the device tables, in slot order."""
    at = 0
    for t in tables:
        t.copy_(host[at:at + t.numel()])
        at += t.numel()


def _reduce_counter(tables) -> np.ndarray:
    """Sum every rank's counts: the tables fetched to the host as one
    [size] array, one ``all_reduce`` over the group, the sums copied back
    (a ``dist.counter_reduce`` span of the table's bytes, its children
    ``.fetch``, ``.allreduce`` and ``.fill``, each of those bytes).  ->
    the global counter on the host."""
    nbytes = sum(t.numel() * t.element_size() for t in tables)
    with span("dist.counter_reduce", nbytes):
        with span("dist.counter_reduce.fetch", nbytes):
            host = torch.cat([t.cpu() for t in tables])
        with span("dist.counter_reduce.allreduce", nbytes):
            distributed.all_reduce_sum_(host)
        with span("dist.counter_reduce.fill", nbytes):
            _fill(tables, host)
            if tables[0].device.type == "cuda":
                torch.cuda.synchronize(tables[0].device)
    return host.numpy()


def _counter_pass_ckpt(ctx: _DistCtx, cfg):
    """The -M counter of stream, filter and hpv16
    (``rkmh_tpu/commands/dist_stream.py:444-466``): restored from the
    ranks' checkpoints when --resume finds them valid (the counting pass
    skipped), else counted and reduced, then saved."""
    fp = (_counter_fingerprint(cfg.read_files, ctx.ks, cfg.counter_size, ctx.dp, ctx.H,
                               ctx.rank) if cfg.out_file else "")
    counter, tables = _new_counter(ctx, cfg)
    if cfg.resume and cfg.out_file:
        table = _load_counter_ckpt(cfg.out_file, fp, cfg.counter_size, ctx.H, ctx.rank)
        if table is not None:
            _fill(tables, torch.from_numpy(table))
            log(f"dist rank {ctx.rank}: -M counter restored from "
                f"{_counter_ckpt_path(cfg.out_file, ctx.rank)}; counting pass skipped")
            return counter
    _count_rows(ctx, cfg, counter)
    table = _reduce_counter(tables)
    if cfg.out_file:
        with span("dist.counter_checkpoint"):
            _save_counter_ckpt(table, cfg.out_file, fp, ctx.H, ctx.rank)
    return counter


# ---- set-up, in pieces: the classify, map, hpv16 and call drains each take
# the refusals and steps they need, in rkmh-tpu's order for that command


def _refused_resume_or_input(cfg, cmd: str, resume: bool = True, work: str = "classify") -> bool:
    """Log and return True when the drain cannot run on these inputs:
    --resume without -o (where ``resume``), or an input that cannot be
    read twice; rkmh-tpu's lines (:489-497 for classify and hpv16, :1053
    for hash, count and search, whose second pass is the "work" pass)."""
    if resume and cfg.resume and not cfg.out_file:
        log(f"{cmd} --dist-* --resume requires -o <file> (resume state is "
            "each rank's partial stripe); refusing to reclassify to stdout")
        return True
    if not _rereadable_inputs(cfg.read_files):
        log(f"{cmd} --dist-* requires re-readable -f files on every host "
            f"(the counting pre-pass and the {work} pass each read the "
            "input; stdin/FIFOs would be consumed by the first)")
        return True
    return False


def _rank_devices(device: torch.device, mesh_devices) -> list:
    """The rank's local devices: ``mesh_devices`` where given; on CUDA the
    rank's share of its host's visible cards (a collective: the host
    names' gather); the one CPU."""
    if mesh_devices is not None or device.type != "cuda":
        return mesh_candidates(device, mesh_devices)
    return distributed.rank_devices(mesh_candidates(device), *distributed.host_local_rank())


def _join_group(cfg, cmd: str) -> _DistCtx | None:
    """Bring up the group and take the rank's local devices, the first its
    current device on CUDA (a ``dist.join`` span; every rank must take as
    many: each owns an equal block of every global batch, and rkmh-tpu
    assumes the same of its processes); None after a logged refusal."""
    device = resolve_device(cfg.device)
    with span("dist.join"):
        try:
            distributed.initialize(cfg.dist_coordinator or None, cfg.dist_procs or None,
                                   cfg.dist_rank if cfg.dist_rank >= 0 else None)
        except ValueError as e:
            log(f"{cmd} --dist-*: {e}")
            return None
        ctx = _DistCtx()
        ctx.H, ctx.rank = distributed.process_count(), distributed.process_index()
        ctx.local = _rank_devices(device, cfg.mesh_devices)
        if device.type == "cuda":
            device = ctx.local[0]
            torch.cuda.set_device(device)
        ctx.device = device
    count("dist.local_devices", len(ctx.local))
    ctx.mesh = ctx.dpc = ctx.sharded = ctx.counter = ctx.panel = None
    n_local = len(ctx.local)
    fewest, most = distributed.allmin(n_local), distributed.allmax(n_local)
    if fewest != most:
        log(f"{cmd} --dist-*: the ranks see {fewest} to {most} local devices; every "
            "rank needs the same count (each owns an equal block of every global batch)")
        return None
    return ctx


def _set_geometry(ctx: _DistCtx, cfg, dp: int) -> None:
    """dp and the global batch: B rounds up to a multiple of dp * H, and
    each rank owns Bl = B / H rows of it."""
    ctx.dp = dp
    B = resolve_batch_size(cfg.batch_size, ctx.device)
    ctx.B = -(-B // (dp * ctx.H)) * (dp * ctx.H)  # % dp == 0 and % H == 0
    ctx.Bl = ctx.B // ctx.H
    ctx.chunk_reads = resolve_chunk_reads(cfg.chunk_reads)


def _scan(ctx: _DistCtx, cfg, tp: int | None) -> None:
    """The input scan (N, the pad length L, the index) and rkmh-tpu's log
    line (``tp`` None: the map drains' line, which names no tp)."""
    ctx.N, maxlen, ctx.index = _scan_input(cfg.read_files, ctx.chunk_reads)
    ctx.L = bucket_length(max(maxlen, 1))
    log(f"dist rank {ctx.rank}/{ctx.H}: {ctx.N} reads, pad {ctx.L}, global batch "
        f"{ctx.B} ({ctx.Bl} rows/host), mesh dp={ctx.dp}"
        f"{'' if tp is None else f' tp={tp}'}{', indexed' if ctx.index is not None else ''}")


def _setup_classify_dist(cfg, cmd: str):
    """The refusals, the process group, the geometry, the panel, the rank's
    grid, the input scan and the -M counter, shared by the stream and
    filter drains (``rkmh_tpu/commands/dist_stream.py:477-582``); None
    after a logged refusal."""
    if getattr(cfg, "in_stream", False):
        log(f"{cmd} --dist-* cannot combine with -i (stdin is host-local "
            "and multi-host batches run in lockstep)")
        return None
    if _refused_resume_or_input(cfg, cmd):
        return None
    ctx = _join_group(cfg, cmd)
    if ctx is None:
        return None
    n_local = len(ctx.local)
    tp = cfg.tp
    if tp < 1 or n_local % tp:
        log(f"{cmd} --dist-*: --tp {tp} must divide the {n_local} local "
            f"devices (panel all_gather must ride intra-host links)")
        return None
    dp = ctx.H * n_local // tp
    if cfg.min_kmer_occ >= 0 and cfg.counter_size % dp:
        log(f"{cmd} --dist-*: -M counter size {cfg.counter_size} is not "
            f"divisible by the {dp} dp shards")
        return None
    _set_geometry(ctx, cfg, dp)
    ctx.ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")

    # every rank builds the same panel from the same files
    ctx.panel = load_or_build_panel(cfg.ref_files, cfg.ref_sketches, ctx.ks, cfg.sketch_size,
                                    ctx.device, max_samples=cfg.max_samples,
                                    counter_size=cfg.counter_size,
                                    distinct_counter=cmd == "filter")
    if ctx.panel.num_refs % tp:
        log(f"{cmd} --dist-*: --tp {tp} does not divide {ctx.panel.num_refs} "
            "references")
        return None
    if n_local > 1:
        ctx.sharded = ShardedCtx(ctx.panel, ctx.ks, n_local, tp, cfg.counter_size, ctx.Bl,
                                 ctx.local)
        ctx.mesh = ctx.sharded.mesh
    _scan(ctx, cfg, tp)
    if cfg.min_kmer_occ >= 0:
        ctx.counter = _counter_pass_ckpt(ctx, cfg)
        if ctx.sharded is not None:
            ctx.sharded.counter = ctx.counter
    return ctx


def _setup_map_dist(cfg, cmd: str):
    """The set-up of the hash, count and search drains
    (``rkmh_tpu/commands/dist_stream.py:1044-1088``): no panel and no tp,
    dp = H * n_local; the rank's grid a dp-only one over its local
    devices.  None after a logged refusal."""
    if _refused_resume_or_input(cfg, cmd, resume=False, work="work"):
        return None
    ctx = _join_group(cfg, cmd)
    if ctx is None:
        return None
    _set_geometry(ctx, cfg, ctx.H * len(ctx.local))
    ctx.ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log(f"Using default kmer size of {DEFAULT_KMER}.")
    if len(ctx.local) > 1:
        ctx.dpc = DpCtx(len(ctx.local), ctx.local)
        ctx.mesh = ctx.dpc.mesh
    _scan(ctx, cfg, None)
    return ctx


def _step(ctx: _DistCtx, cfg, codes: np.ndarray, filter_mode: bool) -> torch.Tensor:
    """Classify a rank's real rows: [3, n] (stream) or [5, n] (filter) on
    its first device."""
    if ctx.sharded is not None:
        return ctx.sharded.step(codes, cfg.sketch_size, cfg.min_diff, cfg.min_matches,
                                cfg.min_kmer_occ, filter_mode=filter_mode)
    batch = to_device(codes, ctx.device)
    fn = engine.filter_codes_table if filter_mode else engine.classify_codes_table
    return fn(batch, ctx.panel, ctx.ks, cfg.sketch_size, cfg.min_diff, cfg.min_matches,
              ctx.counter.table if ctx.sharded is None and ctx.counter is not None else None,
              cfg.min_kmer_occ)


def _watermark(cfg, ctx: _DistCtx, skip: int) -> tuple[int, int]:
    """--resume of a one-line-per-read stripe: (start batch, lines still to
    skip), a collective every rank calls; (0, skip) without --resume."""
    if not cfg.resume:
        return 0, skip
    start_batch, skip = _resume_watermark(skip, ctx.N, ctx.B, ctx.Bl, ctx.rank, ctx.H)
    if start_batch:
        log(f"dist rank {ctx.rank}: watermark — dispatch resumes at "
            f"batch {start_batch} ({skip} overhang lines to skip)")
    return start_batch, skip


def _drain_lines(cfg, ctx: _DistCtx, out, skip: int, start_batch: int, step, lines) -> None:
    """The loop of a one-line-per-read drain (stream, hash, hpv16): for
    every global batch from ``start_batch`` on, ``step(codes, lens)`` of
    the rank's real rows past the resumed ones (dispatched IN_FLIGHT
    batches ahead), then ``lines(names, lens, result)`` written in order."""
    pending: deque = deque()
    for b, codes, lens, names in _iter_owned_batches(
            cfg.read_files, ctx.chunk_reads, ctx.N, ctx.B, ctx.Bl, ctx.rank, ctx.L,
            index=ctx.index, start_batch=start_batch):
        n = _owned_lines(b, ctx.B, ctx.Bl, ctx.rank, ctx.N)
        drop = min(skip, n)  # --resume: these rows' lines already landed
        skip -= drop
        if drop == n:
            continue
        count("reads", n - drop)
        count("bp", int(lens[drop:n].sum()))
        pending.append((names[drop:n], lens[drop:n], step(codes[drop:n], lens[drop:n])))
        if len(pending) > IN_FLIGHT:
            out.write(lines(*pending.popleft()))
    while pending:
        out.write(lines(*pending.popleft()))


def run_distributed(cfg, out=None) -> int:
    """stream --dist-*: this rank's lines of every global batch, in order
    (``rkmh_tpu/commands/dist_stream.py:668-740``)."""
    from rkmh_tpu_torch.commands.stream import format_lines_host

    ctx = _setup_classify_dist(cfg, "stream")
    if ctx is None:
        return 1
    out, close_out, skip = _open_rank_out(cfg, out, ctx.rank, ctx.H, ctx.B, "stream")
    start_batch, skip = _watermark(cfg, ctx, skip)
    try:
        _drain_lines(cfg, ctx, out, skip, start_batch,
                     lambda codes, lens: _step(ctx, cfg, codes, False),
                     lambda names, lens, res: "".join(format_lines_host(
                         ctx.panel.keys, names, res.cpu().numpy(), cfg.sketch_size)))
    finally:
        if close_out:
            out.close()
    return 0


def _reconcile_idx(cfg, ctx: _DistCtx, lines_per_record: int, what: str):
    """--resume of a drain whose stripe has an ``.idx`` (filter, search):
    before the stripe opens, its complete idx lines are the batches that
    landed, the stripe is cut to the lines they cover, and an idx that
    claims more than the stripe holds (or a stripe without an idx) restarts
    the rank; then the all-rank watermark, a collective (every rank calls
    it).  -> (stripe path, idx path, batches already written, start batch)
    (``rkmh_tpu/commands/dist_stream.py:787-823``, ``:1317-1355``)."""
    rank = ctx.rank
    resume_batches = 0
    path = (f"{cfg.out_file}.{rank}" if ctx.H > 1 else cfg.out_file) if cfg.out_file else None
    idx_path = f"{path}.idx" if path else None
    if cfg.resume and path:
        _check_resume_geometry(cfg, ctx.B, ctx.H, os.path.exists(path))
    if cfg.resume and path and os.path.exists(path):
        if os.path.exists(idx_path):
            count_complete_lines(idx_path)  # cut a torn idx tail
            with open(idx_path) as fh:
                counts = [int(x) for x in fh.read().split()]
            resume_batches = len(counts)
            lines = sum(counts) * lines_per_record
            kept = _truncate_to_lines(path, lines)
            if kept < lines:
                log(f"dist rank {rank}: stripe holds {kept} lines but "
                    f"{idx_path} covers {lines}; restarting "
                    "this rank's stripe from scratch")
                os.remove(path)
                os.remove(idx_path)
                resume_batches = 0
            else:
                log(f"dist rank {rank}: resuming, {resume_batches} "
                    f"batches ({sum(counts)} {what}) already landed in "
                    f"{path}")
        else:
            log(f"dist rank {rank}: --resume without {idx_path}; "
                "restarting this rank's stripe from scratch")
            os.remove(path)
    start_batch = _allmin(resume_batches, ctx.H) if cfg.resume else 0
    if start_batch:
        log(f"dist rank {rank}: watermark — dispatch resumes at batch {start_batch}")
    return path, idx_path, resume_batches, start_batch


def run_distributed_filter(cfg, out=None) -> int:
    """filter --dist-*: this rank's passing records, and in ``<stripe>.idx``
    their count for every global batch, written after the records it
    covers.  --resume: the idx is the checkpoint; the stripe is cut to the
    records its (torn-tail-truncated) idx covers, an idx that claims more
    than the stripe holds restarts the rank, and the batches the idx
    covers are not written again (``rkmh_tpu/commands/dist_stream.py:
    761-878``)."""
    from rkmh_tpu_torch.commands.filter_cmd import _record

    ctx = _setup_classify_dist(cfg, "filter")
    if ctx is None:
        return 1
    B, Bl, rank = ctx.B, ctx.Bl, ctx.rank

    _, idx_path, resume_batches, start_batch = _reconcile_idx(cfg, ctx, 4, "records")
    out, close_out, _ = _open_rank_out(cfg, out, rank, ctx.H, B, "filter")
    idx_fh = open(idx_path, "a" if resume_batches else "w") if idx_path else None

    def emit(recs, res):
        wrote = 0
        if res is not None:
            keep = res.cpu().numpy()[3]
            kept = [rec for rec, k in zip(recs, keep) if k]
            out.write("".join(_record(*rec) for rec in kept))
            wrote = len(kept)
        if idx_fh is not None:
            out.flush()  # the idx line never points past the stripe
            idx_fh.write(f"{wrote}\n")
            idx_fh.flush()

    pending: deque = deque()
    try:
        for b, codes, lens, names, recs in _iter_owned_batches(
                cfg.read_files, ctx.chunk_reads, ctx.N, B, Bl, rank, ctx.L,
                with_records=True, index=ctx.index, start_batch=start_batch):
            if b < resume_batches:
                continue  # --resume: this batch's records and idx line already landed
            n = _owned_lines(b, B, Bl, rank, ctx.N)
            if n:
                count("reads", n)
                count("bp", int(lens[:n].sum()))
            pending.append((recs[:n], _step(ctx, cfg, codes[:n], True) if n else None))
            if len(pending) > IN_FLIGHT:
                emit(*pending.popleft())
        while pending:
            emit(*pending.popleft())
    finally:
        if idx_fh is not None:
            idx_fh.close()
        if close_out:
            out.close()
    return 0


def _put(ctx: _DistCtx, codes: np.ndarray, lens=None) -> list:
    """A rank's rows on its devices: one part, or the dp row slices of its
    grid (``commands/common.DpCtx``)."""
    if ctx.dpc is not None:
        return ctx.dpc.put(codes, lens)
    c = to_device(codes, ctx.device)
    return [c] if lens is None else [(c, to_device(lens, ctx.device))]


def run_distributed_hash(cfg, out=None) -> int:
    """hash --dist-*: one line per read of the rank's rows, in ``stream``
    stripes (``rkmh_tpu/commands/dist_stream.py:1101-1212``): K1 (with -s
    the bottom-s sketch, ``torch.sort``) on the rank's devices, the lines
    of ``hash_cmd.hash_lines``.  -K and the JSON dumps are refused, as in
    rkmh-tpu."""
    from rkmh_tpu_torch.commands.hash_cmd import hash_lines

    if cfg.output_kmers:
        log("hash --dist-* cannot combine with -K (kmerize is host-only; "
            "run it single-host)")
        return 1
    if cfg.json_out or cfg.sourmash_out or cfg.out_prefix:
        log("hash --dist-* cannot combine with --json/--sourmash/-o (the "
            "JSON dump collects every record; dump per-rank stripes "
            "instead)")
        return 1
    ctx = _setup_map_dist(cfg, "hash")
    if ctx is None:
        return 1
    ks, s = ctx.ks, cfg.sketch_size
    out, close_out, skip = _open_rank_out(cfg, out, ctx.rank, ctx.H, ctx.B, "stream")
    start_batch, skip = _watermark(cfg, ctx, skip)

    def step(codes, lens):
        if s > 0:
            return [engine.sketch_batch(c, ks, s) for c in _put(ctx, codes)]
        return [engine.hash_batch_with_mask(c, n, ks) for c, n in _put(ctx, codes, lens)]

    def lines(names, lens, parts):
        vals, second = (rows_in_order([p[t] for p in parts])[: len(names)] for t in range(2))
        return hash_lines(cfg, ks, vals, second, names)

    try:
        _drain_lines(cfg, ctx, out, skip, start_batch, step, lines)
    finally:
        if close_out:
            out.close()
    return 0


def run_distributed_count(cfg, out=None) -> int:
    """count --dist-* (``rkmh_tpu/commands/dist_stream.py:1215-1279``): each
    rank counts its own rows (K1 + K6; over its grid's dp slot ranges with
    ``ShardedCounter``) into the whole [size] table, and one
    ``all_reduce`` sums the ranks' tables (in place of rkmh-tpu's
    per-batch ``psum_scatter`` and final gather: integer addition commutes,
    so the table is the same).  The log line's totals are the rank's own
    rows; rank 0 alone writes ``-o`` (npz) and ``--dump``."""
    ctx = _setup_map_dist(cfg, "count")
    if ctx is None:
        return 1
    if cfg.counter_size % ctx.dp:
        log(f"count --dist-*: counter size {cfg.counter_size} is not "
            f"divisible by the {ctx.dp} dp shards")
        return 1
    counter, tables = _new_counter(ctx, cfg)
    total_reads, total_kmers = _count_rows(ctx, cfg, counter)
    table = _reduce_counter(tables)
    occupied = int((table > 0).sum())
    log(f"dist rank {ctx.rank}: counted {total_kmers} kmers from "
        f"{total_reads} owned reads; global {cfg.counter_size}-slot table "
        f"has {occupied} slots occupied.")
    if ctx.rank == 0:
        from rkmh_tpu_torch.commands.count_cmd import write_table

        write_table(cfg, table, ctx.ks, out or sys.stdout)
    return 0


def run_distributed_search(cfg, out=None) -> int:
    """search --dist-* (``rkmh_tpu/commands/dist_stream.py:1282-1403``):
    every rank hashes the reference token files, then K1 and
    ``search_cmd.member_mask`` on its rows.  A read shorter than k writes
    no line, so each rank's ``<out>.<rank>.idx`` holds its line count for
    every global batch (0 included; merged as filter's, one line a
    record); --resume reconciles the idx before the stripe opens, then
    takes the all-rank watermark."""
    from rkmh_tpu_torch.commands.search_cmd import (
        format_search_lines, load_ref_kmers, member_mask, sorted_keys,
    )

    ctx = _setup_map_dist(cfg, "search")
    if ctx is None:
        return 1
    k = ctx.ks[0]  # the reference k-merizes at kmer[0] only (rkmh.cpp:2228)
    ref_hashes = load_ref_kmers(cfg.ref_files)
    log(f"Loaded {len(ref_hashes)} reference kmers.")
    keys = {}  # the sorted keys on each device a slice runs on

    def member(codes: torch.Tensor) -> torch.Tensor:
        if codes.device not in keys:
            keys[codes.device] = sorted_keys(ref_hashes, codes.device)
        return member_mask(kmer_window_hashes(codes, k), keys[codes.device])

    _, idx_path, resume_batches, start_batch = _reconcile_idx(cfg, ctx, 1, "lines")
    out, close_out, _ = _open_rank_out(cfg, out, ctx.rank, ctx.H, ctx.B, "search")
    idx_fh = open(idx_path, "a" if resume_batches else "w") if idx_path else None

    def emit(recs, found):
        wrote = 0
        if found is not None:
            found = rows_in_order(found)[: len(recs)]
            names, seqs = _blob([r[0].encode() for r in recs]), _blob([r[1] for r in recs])
            lens = np.array([len(r[1]) for r in recs], np.int64)
            got = format_search_lines(found, lens, k, np.arange(len(recs)), names, seqs)
            out.write(b"".join(got).decode())
            wrote = sum(1 for line in got if line)
        if idx_fh is not None:
            out.flush()  # the idx line never points past the stripe
            idx_fh.write(f"{wrote}\n")
            idx_fh.flush()

    pending: deque = deque()
    try:
        for b, codes, lens, names, recs in _iter_owned_batches(
                cfg.read_files, ctx.chunk_reads, ctx.N, ctx.B, ctx.Bl, ctx.rank, ctx.L,
                with_records=True, index=ctx.index, start_batch=start_batch):
            if b < resume_batches:
                continue  # --resume: this batch's lines and idx line already landed
            n = _owned_lines(b, ctx.B, ctx.Bl, ctx.rank, ctx.N)
            if n:
                count("reads", n)
                count("bp", int(lens[:n].sum()))
            pending.append((recs[:n], [member(c) for c in _put(ctx, codes[:n])] if n else None))
            if len(pending) > IN_FLIGHT:
                emit(*pending.popleft())
        while pending:
            emit(*pending.popleft())
    finally:
        if idx_fh is not None:
            idx_fh.close()
        if close_out:
            out.close()
    return 0


def _blob(items) -> tuple[bytes, np.ndarray]:
    """Byte strings -> (one blob, [n + 1] offsets)."""
    offs = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in items], out=offs[1:])
    return b"".join(items), offs


def run_distributed_hpv16(cfg, out=None) -> int:
    """hpv16 --dist-* (``rkmh_tpu/commands/dist_stream.py:881-1025``): every
    rank builds the same tables (in tp shards on a grid of its local
    devices), counts -M (``_counter_pass_ckpt``, with rkmh-tpu's ``.mctr``
    checkpoints) and classifies its rows in ``stream`` stripes, on one
    device or with ``ShardedHpv16Comb`` (``ShardedHpv16Sorted`` past the
    set-table cap) over (n_local / tp, tp).  rkmh-tpu probes at the full
    window width, since its one program must be the same on every process;
    a rank here runs no collective step, so it cuts its sorted rows at its
    own rows' width, as one process does (the same bytes)."""
    from rkmh_tpu_torch.commands.hpv16_cmd import build_tables, format_read_lines, make_step

    if _refused_resume_or_input(cfg, "hpv16"):
        return 1
    ctx = _join_group(cfg, "hpv16")
    if ctx is None:
        return 1
    n_local = len(ctx.local)
    tp = max(cfg.tp, 1)
    if n_local % tp:
        log(f"hpv16 --dist-*: --tp {tp} must divide the {n_local} local "
            f"devices (the type-counts all_gather must ride intra-host "
            "links)")
        return 1
    dp = ctx.H * n_local // tp
    if cfg.min_kmer_occ > 0 and cfg.counter_size % dp:
        log(f"hpv16 --dist-*: -M counter size {cfg.counter_size} is not "
            f"divisible by the {dp} dp shards")
        return 1
    _set_geometry(ctx, cfg, dp)
    if not cfg.ks:
        log("NO KMER SIZE PROVIDED. USING A DEFAULT KMER SIZE OF 16")
    ctx.ks = ks = tuple(cfg.ks) if cfg.ks else (16,)
    if n_local > 1:
        ctx.mesh = make_mesh(ctx.local, dp=n_local // tp, tp=tp)
    tb = build_tables(cfg, ks, ctx.device, tp_shards=tp if ctx.mesh is not None else 0)
    _scan(ctx, cfg, tp)
    counter = None
    if cfg.min_kmer_occ > 0:  # rkmh.cpp:2513-2530 counts every read k-mer occurrence
        counter = _counter_pass_ckpt(ctx, cfg)
        if ctx.mesh is None:
            counter = counter.table
    step = make_step(tb, ks, ctx.device, ctx.mesh, counter, cfg.min_kmer_occ)

    out, close_out, skip = _open_rank_out(cfg, out, ctx.rank, ctx.H, ctx.B, "stream")
    start_batch, skip = _watermark(cfg, ctx, skip)
    try:
        _drain_lines(cfg, ctx, out, skip, start_batch, step,
                     lambda names, lens, res: "".join(format_read_lines(
                         tb, ks, names, lens, res.cpu().numpy())))
    finally:
        if close_out:
            out.close()
    return 0


def run_distributed_call(cfg, out=None) -> int:
    """call --dist-* (``rkmh_tpu/commands/dist_stream.py:1465-1639``):
    every rank builds the same depth map from all the reads; a
    reference's P positions split into dp = H * n_local slices of Pl =
    ceil(P / dp), and rank r scans slices [r n_local, (r + 1) n_local) on
    its devices (``ShardedCallScan.scan``: the halo of its first slice is
    made from the whole map, where rkmh-tpu passes it over the mesh with
    ``ppermute``) and writes the records of its positions as a partial
    section of ``<out>.<rank>`` with a ``ref_done`` line.  Below a window a
    slice (Pl < w), rank 0 owns every position and the others write empty
    sections.  --resume keeps rkmh-tpu's geometry guards and cuts a
    stripe to its complete sections; a reference whose section landed is
    not scanned again (rkmh-tpu scans it for lockstep; the output is the
    same).  The merge tool makes the VCF."""
    from rkmh_tpu_torch.commands.call_cmd import (
        CallAggregator, build_depth_map, extract_records, load_partials,
    )

    if cfg.show_depth:
        log("call --dist-* does not support -d/--show-depth (per-position "
            "dump is a debugging surface; run it single-host)")
        return 1
    if not cfg.out_file:
        log("call --dist-* requires -o <file> (per-rank partials merge "
            "with rkmh-tpu-dist-merge)")
        return 1
    if not _rereadable_inputs(cfg.read_files):
        log("call --dist-* requires re-readable -f files on every host")
        return 1
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")
        ks = (16,)
    elif len(cfg.ks) > 1:
        log("Only a single kmer size may be used for calling.")
        return 1
    else:
        ks = tuple(cfg.ks)
    k = ks[0]
    ctx = _join_group(cfg, "call")
    if ctx is None:
        return 1
    H, rank, n_local = ctx.H, ctx.rank, len(ctx.local)
    ndev = H * n_local

    refs = load_records(cfg.ref_files)
    reads = load_packed(cfg.read_files)
    if not refs or not len(reads):
        log("call requires at least one reference and one read file.")
        return 1
    table = build_depth_map(reads, ks, resolve_batch_size(cfg.batch_size, ctx.device),
                            ctx.device)
    if len(refs) > 1:
        log("WARNING: more than one ref provided. VCF will not be correct")
    scan = ShardedCallScan(make_mesh(ctx.local, dp=n_local, tp=1), table, k, cfg.window_len)

    path = f"{cfg.out_file}.{rank}"
    done_refs: list[str] = []
    refs_total = sum(1 for r in refs if len(r.seq) >= k)
    if cfg.resume:
        # before load_partials cuts the stripe or the sidecar is rewritten:
        # a stripe's positions depend on (procs, devices)
        meta = _load_meta(cfg.out_file)
        if meta is None:
            if os.path.exists(path):
                raise RuntimeError(
                    f"--resume needs the {cfg.out_file}.dist.json sidecar "
                    "of the interrupted run to verify the stripe geometry, "
                    "and it is missing or unreadable — rerun without "
                    "--resume")
        elif (meta.get("procs"), meta.get("devices")) != (H, ndev):
            raise RuntimeError(
                f"--resume geometry mismatch: {cfg.out_file}.dist.json "
                f"records procs={meta.get('procs')} devices="
                f"{meta.get('devices')} but this run would use {H}/{ndev} "
                "— rerun with the original process/device layout or "
                "without --resume")
        done_refs, _ = load_partials(path, truncate=True)
        if done_refs:
            log(f"dist rank {rank}: resuming, {len(done_refs)} ref "
                f"section(s) already in {path}")
        fh = open(path, "a")
    else:
        fh = open(path, "w")
    _write_meta(cfg.out_file, 0, H, "call",
                extra={"reference": cfg.ref_files[0], "devices": ndev,
                       "refs_total": refs_total})
    done_iter = iter(done_refs)
    pending_done = next(done_iter, None)
    log(f"dist rank {rank}/{H}: {len(refs)} ref(s), mesh dp={ndev} ({n_local} local)")

    try:
        for ref in refs:
            if len(ref.seq) < k:
                continue
            if pending_done is not None and pending_done == ref.name:
                pending_done = next(done_iter, None)
                continue  # --resume: this reference's section already landed
            P = len(ref.seq) - k + 1
            Pl = -(-P // ndev)
            row = encode_seqs([ref.seq])[0][0, : len(ref.seq)]
            mine = None
            if Pl >= cfg.window_len:
                j_lo = row_off = rank * n_local * Pl
                j_hi = j_lo + n_local * Pl
                if j_lo < P:  # else every position of the rank's slices is padding
                    mine = scan.scan(row, ndev, rank * n_local)
            else:  # a short genome: rank 0 owns every position
                j_lo, j_hi, row_off = 0, (P if rank == 0 else 0), 0
                if rank == 0:
                    res = call_scan_ref(to_device(row, ctx.device, non_blocking=False), table,
                                        k, cfg.window_len)
                    mine = {name: v.cpu().numpy() for name, v in res.items()}
            ref_agg = CallAggregator()
            extract_records(ref.name, row, mine, P, k, ref_agg.record,
                            j_lo=j_lo, j_hi=j_hi, row_off=row_off)
            lines = ref_agg.dump_lines()
            fh.writelines(lines)
            fh.write(json.dumps({"ref_done": ref.name, "n": len(lines)}) + "\n")
            fh.flush()
    finally:
        fh.close()
    return 0


def merge_outputs(rank_files, batch_size: int, out=None) -> int:
    """Interleave one-line-per-read stripes back into one process's order:
    a block of batch_size / H lines from each rank in turn (a
    ``dist.merge`` span of the stripes' bytes, which it writes whole)."""
    out = out or sys.stdout
    Bl = batch_size // len(rank_files)
    fhs = [open(p) for p in rank_files]
    try:
        with span("dist.merge", sum(os.fstat(fh.fileno()).st_size for fh in fhs)):
            while True:
                got = 0
                for fh in fhs:
                    for _ in range(Bl):
                        line = fh.readline()
                        if not line:
                            break
                        out.write(line)
                        got += 1
                if not got:
                    return 0
    finally:
        for fh in fhs:
            fh.close()


def merge_outputs_filter(rank_files, lines_per_record: int = 4, out=None) -> int:
    """Merge variable-size stripes by their ``.idx`` counts (one per global
    batch); idx files of different lengths are refused."""
    out = out or sys.stdout
    fhs = [open(p) for p in rank_files]
    idx = [open(f"{p}.idx") for p in rank_files]
    try:
        batch = 0
        while True:
            counts = [i.readline() for i in idx]
            if not any(counts):
                return 0
            if not all(counts):
                short = [rank_files[j] for j, c in enumerate(counts) if not c]
                raise RuntimeError(
                    f"rank idx files disagree at batch {batch}: "
                    f"{short} ended early — the interrupted rank(s) must "
                    "be rerun with --resume before merging")
            for fh, c in zip(fhs, counts):
                for _ in range(int(c) * lines_per_record):
                    out.write(fh.readline())
            batch += 1
    finally:
        for fh in fhs + idx:
            fh.close()


def merge_outputs_call(rank_files, reference: str, out=None,
                       refs_total: int | None = None) -> int:
    """Merge call's partial sections into the VCF (the header, then the
    records in ``std::map`` order; aggregation commutes, so it equals one
    process's).  Refused, as rkmh-tpu refuses them
    (``rkmh_tpu/commands/dist_stream.py:1642-1677``): a rank whose complete
    sections differ from the first rank's, or number other than the
    sidecar's ``refs_total`` (a rank that ended early)."""
    from rkmh_tpu_torch.commands.call_cmd import CallAggregator, load_partials, vcf_header

    out = out or sys.stdout
    agg = CallAggregator()
    first: tuple[str, list] | None = None
    for p in rank_files:
        done, part = load_partials(p)
        if refs_total is not None and len(done) != refs_total:
            raise RuntimeError(
                f"{p} holds {len(done)}/{refs_total} complete ref "
                "section(s) — that rank's drain ended early; rerun it "
                "with --resume before merging")
        if first is None:
            first = (p, done)
        elif done != first[1]:
            raise RuntimeError(
                f"rank stripes disagree: {p} holds {len(done)} complete "
                f"ref section(s) vs {len(first[1])} in {first[0]} — a "
                "rank ended early; rerun it with --resume before merging")
        agg.merge_from(part)
    out.write(vcf_header(reference))
    agg.emit_vcf_records(out)
    return 0


def merge_main(argv=None) -> int:
    """``rkmh-tpu-torch-dist-merge out.0 out.1 ...``: the stripes' geometry
    and format come from ``<out>.dist.json`` (``-b`` overrides the global
    batch); formats stream (stream, hpv16 and hash stripes), filter and
    search (``.idx`` counts) and call (partial sections merged into the
    VCF)."""
    import argparse
    import re

    ap = argparse.ArgumentParser(
        prog="rkmh-tpu-torch-dist-merge",
        description="Merge rkmh-tpu(-torch) --dist-* per-rank outputs (stream, filter, hpv16, "
                    "hash, search, call) into single-process order.")
    ap.add_argument("-b", "--batch-size", type=int, default=0,
                    help="override the GLOBAL batch size (default: read it from the "
                         "<out>.dist.json sidecar)")
    ap.add_argument("rank_files", nargs="+",
                    help="per-rank outputs in rank order (out.0 out.1 ...)")
    args = ap.parse_args(argv)
    B, fmt = args.batch_size, "stream"
    base = re.sub(r"\.\d+$", "", args.rank_files[0])
    meta_path = f"{base}.dist.json"
    meta = _load_meta(base)
    if meta is not None:
        fmt = meta.get("format", "stream")
        if not B:
            if meta.get("procs") != len(args.rank_files):
                ap.error(f"{meta_path} records {meta.get('procs')} ranks but "
                         f"{len(args.rank_files)} files were given")
            B = int(meta["global_batch"])
    elif all(os.path.exists(f"{p}.idx") for p in args.rank_files):
        fmt = "filter"  # the sidecar is lost, but the idx files name the format
    if fmt == "search":
        return merge_outputs_filter(args.rank_files, lines_per_record=1)
    if fmt == "filter":
        return merge_outputs_filter(args.rank_files)
    if fmt == "call":
        if meta is None or "reference" not in meta:
            ap.error(f"call merge needs the {meta_path} sidecar (it holds "
                     "the ##reference header path)")
        return merge_outputs_call(args.rank_files, meta["reference"],
                                  refs_total=meta.get("refs_total"))
    if not B:
        ap.error(f"no {meta_path} sidecar next to the rank files; "
                 "pass -b <global batch> explicitly")
    return merge_outputs(args.rank_files, B)


if __name__ == "__main__":
    raise SystemExit(merge_main())
