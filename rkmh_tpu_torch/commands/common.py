"""Shared command plumbing: the reference panel, input chunks, the -M
counter pass, batching and the pipelined dispatch/fetch/emit loop.

Counterpart of ``rkmh_tpu/commands/common.py:17-553``, and of :573-724
for ``--devices`` / ``--tp`` (``sharded_geometry_reason``, ``ShardedCtx``,
``DpCtx``: a (dp, tp) grid of devices in one process, ``parallel/``).
Differences:

* the panel is an ``nn.Module`` whose tables are buffers, built on the
  requested device.  The on-disk panel cache (``RKMH_TPU_PANEL_CACHE``,
  ``_panel_cache_path``) is the JAX package's: the same key, file name and
  payload, so an entry either package writes is a hit for the other;
* path inputs go through the port's own copy of the native C++ parser
  (``io/native``), built at first use; a build failure raises.  Stdin
  (``-``) and file objects go through the Python parser (``io/fastx``),
  as in the JAX package;
* batches are not padded to powers of two: that padding only bounded the
  number of XLA compilations, and eager PyTorch compiles nothing;
* ``ChunkedPipeline`` takes the fetch function as an argument.
"""

from __future__ import annotations

import os
import queue
import stat
import sys
import threading
from collections import deque

import numpy as np
import torch
from torch import nn

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.recovery import InjectedFailure
from rkmh_tpu_torch.io import native
from rkmh_tpu_torch.io.fastx import iter_batches, read_fastx
from rkmh_tpu_torch.io.packing import PAD_CODE, encode_seqs, length_buckets
from rkmh_tpu_torch.device import to_device
from rkmh_tpu_torch.observability import count, span
from rkmh_tpu_torch.ops.counter import HashCounter
from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
from rkmh_tpu_torch.ops.lookup import build_panel_table, build_panel_table_device
from rkmh_tpu_torch.ops.probe import device_table
from rkmh_tpu_torch.parallel.ep import ShardedCounter
from rkmh_tpu_torch.parallel.mesh import (
    ShardedPanel,
    make_mesh,
    sharded_classify_step,
    sharded_filter_step,
    visible_devices,
)

DEFAULT_KMER = 16          # rkmh.cpp:728-731
DEFAULT_SKETCH = 1000      # rkmh.cpp:592
DEFAULT_COUNTER_SIZE = 200_000_000  # stream's counters, rkmh.cpp:739-742
DEFAULT_BATCH_CPU = 2048
DEFAULT_BATCH_CUDA = 16384
DEFAULT_CHUNK_READS = 65536
# sketch elements (R * s) from which a panel's table is built on the device,
# below them on the host (rkmh_tpu/commands/common.py:98)
DEVICE_BUILD_MIN_ELEMENTS = 2_000_000
FETCH_GROUP = 4            # results fetched per host sync; not tuned yet
READ_AHEAD = 1             # parsed chunks a reader thread may hold ahead of their consumer
MAX_LENGTH_BUCKETS = 4     # padded-length buckets per chunk


def log(msg: str):
    print(msg, file=sys.stderr)


def resolve_batch_size(requested: int, device: torch.device) -> int:
    """0 = auto: large batches on the GPU, modest ones on the CPU."""
    if requested and requested > 0:
        return requested
    return DEFAULT_BATCH_CUDA if device.type == "cuda" else DEFAULT_BATCH_CPU


class RefPanel(nn.Module):
    """A reference panel on one device: names, sorted bottom-s sketches
    [R, s] int64 (SENTINEL-padded), their lengths [R] int32, and the
    table the probe queries: the bucket table [NB, S*(3+Wm)] int32 or,
    past ``ops/probe.MAX_REFS`` on a GPU, its ``WideTable``
    (``ops/probe.device_table``)."""

    def __init__(self, keys, sketches: torch.Tensor, lens: torch.Tensor, table):
        super().__init__()
        self.keys = list(keys)
        self.register_buffer("sketches", sketches)
        self.register_buffer("lens", lens)
        if isinstance(table, torch.Tensor):
            self.register_buffer("table", table)
        else:
            self.table = table

    @property
    def num_refs(self) -> int:
        return len(self.keys)


def build_ref_panel(ref_packed, ks, sketch_size: int, device: torch.device,
                    max_samples: int | None = None,
                    counter_size: int = DEFAULT_COUNTER_SIZE,
                    distinct_counter: bool = False) -> RefPanel:
    """Hash and sketch a parsed panel on ``device``, then build its table
    (``_panel_from_sketches``: a panel of DEVICE_BUILD_MIN_ELEMENTS sketch
    elements or more on the device, a smaller one on the host, each
    identical to the JAX package's build of that size); past MAX_REFS on
    a GPU the probe takes the table's packed form.

    With max_samples set (-I), the panel's k-mers are counted first in a
    ``hash % counter_size`` counter on the device (every occurrence for
    stream, rkmh.cpp:828-837; once per reference with distinct_counter,
    for filter, rkmh.cpp:340-357), and only hashes counted at most
    max_samples times enter the sketches."""
    codes = torch.from_numpy(ref_packed.codes).to(device)
    if max_samples is None:
        sk, sk_lens = engine.sketch_batch(codes, ks, sketch_size)
    else:
        lens = torch.from_numpy(ref_packed.lens).to(device)
        counter = HashCounter(counter_size, device)
        if distinct_counter:
            counter.add(*engine.distinct_hash_mask(codes, lens, ks))
        else:
            counter.add(*engine.hash_batch_with_mask(codes, lens, ks))
        sk, sk_lens = engine.sketch_batch_informative(codes, counter.table, ks, sketch_size,
                                                      max_samples)
        del counter
    return _panel_from_sketches(ref_packed.names, sk, sk_lens, None, None, device)


def _panel_from_sketches(names, sk: torch.Tensor, sk_lens: torch.Tensor,
                         sk_np: np.ndarray | None, lens_np: np.ndarray | None,
                         device: torch.device) -> RefPanel:
    """A RefPanel of sketches on ``device`` and their host copies (None:
    fetched where needed): as rkmh-tpu decides (``_panel_table_arrays``,
    rkmh_tpu/commands/common.py:93-107), a panel of fewer than
    DEVICE_BUILD_MIN_ELEMENTS sketch elements gets its table built on the
    host and copied, a larger one on the device (``build_panel_table_device``);
    the build and cache-hit paths share it."""
    if sk.numel() < DEVICE_BUILD_MIN_ELEMENTS:
        if sk_np is None:
            sk_np, lens_np = sk.cpu().numpy(), sk_lens.cpu().numpy()
        table = build_panel_table(sk_np, lens_np).table.view(np.int32)
    else:
        table = build_panel_table_device(sk, sk_lens)
    return RefPanel(names, sk, sk_lens, device_table(table, len(names), device))


_PANEL_CACHE_VERSION = 2  # v2: pickle-free payload, length-framed key


def _panel_cache_path(ref_files, ks, sketch_size, max_samples, counter_size,
                      distinct_counter) -> str | None:
    """Content-addressed cache file for a built reference panel, or None
    when caching is disabled (RKMH_TPU_PANEL_CACHE=0) or the refs are not
    plain files.  A copy of ``rkmh_tpu/commands/common.py:113``: the same
    key (the length-framed reference bytes and every sketching parameter)
    and directory (RKMH_TPU_PANEL_CACHE, else ~/.cache/rkmh_tpu/panels)."""
    import hashlib

    env = os.environ.get("RKMH_TPU_PANEL_CACHE", "")
    if env == "0":
        return None
    cache_dir = env or os.path.join(
        os.path.expanduser("~"), ".cache", "rkmh_tpu", "panels"
    )
    h = hashlib.sha256()
    h.update(repr((
        _PANEL_CACHE_VERSION, tuple(ks), sketch_size, max_samples,
        counter_size if max_samples is not None else None, distinct_counter,
    )).encode())
    try:
        for p in _as_list(ref_files):
            if p in ("-", b"-"):
                return None
            with open(p, "rb") as fh:
                data = fh.read()
            # length-framed: different file splits of identical
            # concatenated bytes must not collide onto one key
            h.update(len(data).to_bytes(8, "little"))
            h.update(data)
    except OSError:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    return os.path.join(cache_dir, h.hexdigest()[:32] + ".npz")


def build_ref_panel_from_files(ref_files, ks, sketch_size: int, device: torch.device,
                               max_samples: int | None = None,
                               counter_size: int = DEFAULT_COUNTER_SIZE,
                               distinct_counter: bool = False) -> RefPanel:
    """build_ref_panel over files parsed and concatenated in order
    (``load_packed``), with the JAX package's content-addressed on-disk
    sketch cache (``rkmh_tpu/commands/common.py:151``).

    On a hit no reference is parsed or hashed: the sketches, lengths and
    names come from the entry (``sk`` uint64, ``lens`` int32, ``names`` a
    fixed-width unicode array; loaded without pickle) and only the table is
    built.  A miss builds the panel and writes the entry through a unique
    temporary file and an atomic replace.  An unreadable entry is rebuilt
    and overwritten.  Disable with RKMH_TPU_PANEL_CACHE=0; a directory
    there moves the cache."""
    path = _panel_cache_path(ref_files, ks, sketch_size, max_samples,
                             counter_size, distinct_counter)
    if path is not None and os.path.exists(path):
        try:
            z = np.load(path)
            sk_np = np.ascontiguousarray(z["sk"], dtype=np.uint64)
            lens_np = z["lens"].astype(np.int32)
            names = [str(x) for x in z["names"]]
        except Exception as e:  # corrupt entry: rebuild and overwrite
            log(f"panel cache entry unreadable ({e!r}); rebuilding")
        else:
            sk = torch.from_numpy(sk_np.view(np.int64)).to(device)
            return _panel_from_sketches(names, sk, torch.from_numpy(lens_np).to(device),
                                        sk_np, lens_np, device)

    panel = build_ref_panel(load_packed(ref_files), ks, sketch_size, device,
                            max_samples=max_samples, counter_size=counter_size,
                            distinct_counter=distinct_counter)
    if path is not None:
        # unique tmp + atomic replace: concurrent cold-start runs must
        # not interleave writes or observe partial files
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                np.savez_compressed(
                    fh, sk=panel.sketches.cpu().numpy().view(np.uint64),
                    lens=panel.lens.cpu().numpy(),
                    names=np.asarray([str(k) for k in panel.keys]),
                )
            os.replace(tmp, path)
        except OSError as e:
            log(f"panel cache write skipped ({e})")
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return panel


def load_or_build_panel(ref_files, ref_sketches: str, ks, sketch_size: int,
                        device: torch.device, **counter_kw) -> RefPanel:
    """stream and filter's panel: with ``ref_sketches`` (--ref-sketches /
    -R) the sketches of that JSON file (``io.sketch_json``), neither hashing
    the references nor counting them for -I; otherwise
    ``build_ref_panel_from_files``."""
    if ref_sketches:
        from rkmh_tpu_torch.io.sketch_json import load_sketches, panel_from_sketches

        with open(ref_sketches) as fh:
            return panel_from_sketches(load_sketches(fh), sketch_size, device)
    return build_ref_panel_from_files(ref_files, ks, sketch_size, device, **counter_kw)


class PyPacked:
    """Parsed records as [N, L] codes + lengths + names, and the raw
    sequences and qualities (None for FASTA) that filter re-emits: the
    interface of ``io.native.PackedReads`` over the Python parser's
    records."""

    def __init__(self, records):
        self.codes, self.lens = encode_seqs([r.seq for r in records])
        self.names = [r.name for r in records]
        self.seqs = [r.seq for r in records]
        self.quals = [r.qual for r in records]

    def __len__(self):
        return len(self.names)

    def tail(self, start: int) -> PyPacked:
        """The records from ``start`` on (a resumed run's first chunk)."""
        out = PyPacked([])
        out.codes, out.lens = self.codes[start:], self.lens[start:]
        out.names, out.seqs, out.quals = (self.names[start:], self.seqs[start:],
                                          self.quals[start:])
        return out


def _is_path(p) -> bool:
    """A file path the native parser reads (not ``-`` nor a file object)."""
    return isinstance(p, (str, bytes, os.PathLike)) and p not in ("-", b"-")


def load_packed(paths):
    """Parse files, concatenated in order, into one packed set of records
    (``rkmh_tpu/commands/common.py:237``): each path by the native parser
    (a PackedReads), ``-`` and file objects by the Python parser (a
    PyPacked).  Several files merge into one PyPacked whose rows are padded
    to the widest file's width."""
    parts = [native.read_fastx_packed(p) if _is_path(p) else PyPacked(read_fastx([p]))
             for p in _as_list(paths)]
    if len(parts) == 1:
        return parts[0]
    merged = PyPacked([])
    merged.codes = np.full((sum(len(p) for p in parts), max(p.codes.shape[1] for p in parts)),
                           PAD_CODE, dtype=np.uint8)
    merged.lens = np.concatenate([p.lens for p in parts]).astype(np.int32)
    at = 0
    for p in parts:
        merged.codes[at: at + len(p), : p.codes.shape[1]] = p.codes
        merged.names += p.names
        merged.seqs += p.seqs
        merged.quals += p.quals
        at += len(p)
    return merged


def load_records(paths) -> list:
    """Parse files, concatenated in order, into SeqRecords by the Python
    parser (``rkmh_tpu/commands/common.py:216``; ``call`` reads its
    references so)."""
    return read_fastx(paths)


def resolve_chunk_reads(requested: int) -> int:
    """Reads per parsed chunk: ``requested`` if > 0, else
    RKMH_TPU_CHUNK_READS if it is a positive integer, else the default
    (65536), as ``rkmh_tpu/commands/common.py:295`` resolves it."""
    if requested and requested > 0:
        return requested
    env = os.environ.get("RKMH_TPU_CHUNK_READS", "")
    if env.isdigit() and int(env) > 0:
        return int(env)
    return DEFAULT_CHUNK_READS


def _as_list(paths) -> list:
    """A single path or file object -> [it]; a list or tuple as it is."""
    return list(paths) if isinstance(paths, (list, tuple)) else [paths]


def read_ahead(items, depth: int = READ_AHEAD):
    """Yield what the iterable ``items`` yields, in order, while a thread
    produces up to ``depth`` items ahead.  Worth it where producing an item
    releases the interpreter lock (the native parser runs in C, outside
    it), so the parse of the next chunk overlaps the work on this one.  An
    exception of ``items`` is raised here, in order; closing this
    generator stops the thread and closes ``items``.  The consumer's wait
    is an ``input.wait`` span, the thread's wait on a full queue an
    ``input.handoff`` span."""
    done = object()
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(entry) -> bool:
        if stop.is_set():
            return False
        try:
            q.put_nowait(entry)
            return True
        except queue.Full:
            pass
        with span("input.handoff"):
            while not stop.is_set():
                try:
                    q.put(entry, timeout=0.05)
                    return True
                except queue.Full:
                    pass
        return False

    def produce():
        try:
            for item in items:
                if not put((item, None)):
                    return
            put((done, None))
        except Exception as e:  # raised by the consumer, after the items before it
            put((done, e))
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=produce, name="rkmh-read-ahead", daemon=True)
    thread.start()
    try:
        while True:
            with span("input.wait"):
                item, error = q.get()
            if error is not None:
                raise error
            if item is done:
                return
            yield item
    finally:
        stop.set()
        thread.join()


def _native_chunks(path, chunk_reads: int):
    with native.FastxStream(path) as stream:
        while (chunk := stream.next_chunk(chunk_reads)) is not None:
            yield chunk


def iter_packed_chunks(paths, chunk_reads: int):
    """Yield chunks of <= chunk_reads records, files in order (chunks
    never span files), so that one parsed chunk is in use and at most
    READ_AHEAD more wait (``rkmh_tpu/commands/common.py:308``).  ``paths``
    holds paths, read by the native parser into PackedReads on a reader
    thread (``read_ahead``), or ``-`` (stdin) and binary file objects, read
    by the Python parser into PyPacked."""
    for p in _as_list(paths):
        if _is_path(p):
            yield from read_ahead(_native_chunks(p, chunk_reads))
        else:
            for recs in iter_batches(p, chunk_reads):
                yield PyPacked(recs)


def _rereadable(p) -> bool:
    if not _is_path(p):
        return False
    try:
        return not stat.S_ISFIFO(os.stat(p).st_mode)
    except OSError:
        return True  # let the parser raise the error for a missing file


def two_pass_chunks(paths, chunk_reads: int):
    """(first-pass iterable, second-pass factory) over packed chunks,
    for the -M commands, which read their input twice (counter pass, then
    classify pass).  Plain files are read again from disk; stdin, FIFOs
    and file objects can be read once only, so their chunks are buffered
    for the second pass (``rkmh_tpu/commands/common.py:353``)."""
    paths = _as_list(paths)
    if all(_rereadable(p) for p in paths):
        return (iter_packed_chunks(paths, chunk_reads),
                lambda: iter_packed_chunks(paths, chunk_reads))
    chunks = list(iter_packed_chunks(paths, chunk_reads))
    return iter(chunks), lambda: iter(chunks)


def count_read_kmers(chunks, ks, counter_size: int, batch_size: int,
                     device: torch.device, dpc: DpCtx | None = None) -> HashCounter:
    """The -M counter pass: every window of every read (hash 0 of an
    invalid k-mer included, padding excluded) into a new ``hash %
    counter_size`` counter on ``device`` (rkmh.cpp:903-910).  With ``dpc``
    (count --devices) each dp slice is hashed on its own device and added
    into the one table on the first.  A ``counter.pass`` span, the wait for
    the input included."""
    counter = HashCounter(counter_size, dpc.mesh[0, 0] if dpc is not None else device)
    at = counter.table.device
    with span("counter.pass"):
        for chunk in chunks:
            for _, codes, lens in bucketed_batches(chunk, batch_size):
                for c, n in (dpc.put(codes, lens) if dpc is not None else
                             [(to_device(codes, device), to_device(lens, device))]):
                    counter.add_windows(multi_k_window_hashes(c, ks).to(at, non_blocking=True),
                                        n.to(at, non_blocking=True), codes.shape[1], ks)
    return counter


def bucketed_batches(packed, batch_size: int):
    """Yield (rows [B] indices into the chunk, codes [B, Lb], lens [B])
    grouped by padded-length bucket (``io.packing.length_buckets``), so a
    length-spread input pads each read only to its bucket's length.  Each
    batch adds its reads and bases to the run's metrics, as rkmh-tpu's
    batchers do (``rkmh_tpu/commands/common.py:479-480, 538-539``)."""
    if len(packed) == 0:
        return
    uniq, bidx = length_buckets(packed.lens, MAX_LENGTH_BUCKETS)
    for b, Lb in enumerate(uniq):
        sel = np.nonzero(bidx == b)[0]
        for off in range(0, len(sel), batch_size):
            rows = sel[off : off + batch_size]
            lens = packed.lens[rows]
            count("reads", len(rows))
            count("bp", int(lens.sum()))
            yield rows, packed.codes[rows][:, : int(Lb)], lens


class ChunkState:
    """A chunk moving through ChunkedPipeline: complete once all its
    batches were dispatched and their results landed."""

    __slots__ = ("n", "filled", "dispatched")

    def __init__(self, n: int):
        self.n = n
        self.filled = 0
        self.dispatched = False

    @property
    def complete(self) -> bool:
        return self.dispatched and self.filled == self.n


class NamesOnly:
    """What the output needs of a parsed chunk: the native parser's name
    blob and offsets, or the Python parser's names.  A chunk state holds
    this and not the chunk, so that the chunk's codes and sequence blobs
    are freed once its batches are dispatched."""

    __slots__ = ("blob", "offs", "_names")

    def __init__(self, chunk):
        self.blob = getattr(chunk, "_names_blob", None)
        self.offs = getattr(chunk, "_name_offs", None)
        self._names = None if self.blob is not None else chunk.names

    @property
    def names(self) -> list[str]:
        if self._names is None:
            o = self.offs.tolist()
            self._names = [self.blob[o[i]: o[i + 1]].decode() for i in range(len(o) - 1)]
        return self._names


class LinesChunk(ChunkState):
    """Per-input-chunk output buffer: batches land in length-bucket order
    and the chunk is written in input order once every row has arrived.
    Each part is (first row, block of lines) for a batch of contiguous rows
    formatted natively, or (rows, lines) for one formatted line by line."""

    __slots__ = ("chunk", "parts")

    def __init__(self, chunk):
        super().__init__(len(chunk))
        self.chunk = NamesOnly(chunk)
        self.parts = []

    def render(self) -> str:
        if all(isinstance(key, int) for key, _ in self.parts):
            return "".join(text for _, text in sorted(self.parts, key=lambda p: p[0]))
        lines = [None] * self.n
        for key, payload in self.parts:
            if isinstance(key, int):
                payload = [line + "\n" for line in payload.split("\n")[:-1]]
                key = range(key, key + len(payload))
            for i, line in zip(key, payload):
                lines[i] = line
        return "".join(lines)


def _nbytes(x) -> int:
    """The bytes of a fetched result: an array, or lists and tuples of them."""
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(a) for a in x)
    return int(getattr(x, "nbytes", 0))


class ChunkedPipeline:
    """Dispatch -> grouped fetch -> in-order emit.

    Dispatches are asynchronous on the device; up to 2 * group batch
    results stay in flight and are fetched group at a time (FETCH_GROUP by
    default).  Chunks are emitted in input order the moment they complete,
    so residency is the in-flight window plus ~2 chunks, whatever the input
    size.

    on_result(state, meta, host_array): record one batch's fetched result
        into its chunk state and advance state.filled (an ``output.format``
        span a batch).
    emit(state): write one completed chunk's output (``output.emit``).
    fetch(device_results) -> host arrays, in order (``device.fetch``, of
        the arrays' bytes).
    fail_after: raise ``InjectedFailure`` right after the chunk of that
        number is emitted (0: never); the commands whose rkmh-tpu
        pipeline does so pass ``recovery.fail_after_chunks()``.
    """

    def __init__(self, on_result, emit, fetch, group: int = FETCH_GROUP,
                 fail_after: int = 0):
        self.on_result = on_result
        self.emit = emit
        self.fetch = fetch
        self.group = group
        self.fail_after = fail_after
        self.emitted = 0
        self.pending = deque()   # (state, meta, device_result)
        self.emit_q = deque()    # chunk states in input order

    def _drain(self):
        while self.emit_q and self.emit_q[0].complete:
            with span("output.emit"):
                self.emit(self.emit_q.popleft())
            self.emitted += 1
            if self.fail_after and self.emitted >= self.fail_after:
                raise InjectedFailure(f"RKMH_TPU_FAIL_AFTER_CHUNKS={self.fail_after} tripped")

    def _flush(self, n: int):
        group = [self.pending.popleft() for _ in range(min(n, len(self.pending)))]
        with span("device.fetch") as s:
            fetched = self.fetch([res for *_, res in group])
            s.nbytes = _nbytes(fetched)
        for (st, meta, _), arr in zip(group, fetched):
            with span("output.format"):
                self.on_result(st, meta, arr)
        self._drain()

    def run(self, chunk_iter, make_state, dispatch, batch_size: int):
        """Drive chunks end to end; dispatch(state, rows, codes, lens) ->
        (meta, device_result) for each bucketed batch of each chunk."""
        for chunk in chunk_iter:
            st = make_state(chunk)
            self.emit_q.append(st)
            for rows, codes, lens in bucketed_batches(chunk, batch_size):
                self.pending.append((st, *dispatch(st, rows, codes, lens)))
                if len(self.pending) > 2 * self.group:
                    self._flush(self.group)
            st.dispatched = True
        while self.pending:
            self._flush(len(self.pending))
        self._drain()


def sharded_geometry_reason(devices: int, tp: int, num_refs: int | None, n_visible: int,
                            min_kmer_occ: int = -1, counter_size: int = 0) -> str | None:
    """Why a --devices geometry cannot apply (None = it can); the reasons
    of ``rkmh_tpu/commands/common.py:573``, word for word.  ``num_refs``
    None: a panel that pads itself to a multiple of tp (hpv16's)."""
    if tp < 1 or devices % tp:
        return f"--devices {devices} is not divisible by --tp {tp}"
    if devices > n_visible:
        return f"--devices {devices} > {n_visible} visible device(s)"
    if min_kmer_occ >= 0 and counter_size % (devices // tp):
        return (f"-M counter size {counter_size} is not divisible by "
                f"the {devices // tp} dp shards")
    if num_refs is not None and num_refs % tp:
        return f"--tp {tp} does not divide {num_refs} references"
    return None


def mesh_candidates(device: torch.device, mesh_devices=None) -> list:
    """The devices a --devices run takes its grid from: ``mesh_devices``
    when given (the tests' and chip_smoke's seam), else every visible
    device of ``device``'s kind."""
    return list(mesh_devices) if mesh_devices is not None else visible_devices(device)


def pad_rows(codes: np.ndarray, lens, dp: int):
    """Pad a batch to a dp multiple with all-invalid reads (code 4, length
    0); consumers index only the real rows.  -> (codes, lens or None)."""
    pad = (-codes.shape[0]) % dp
    if pad:
        codes = np.concatenate([codes, np.full((pad, codes.shape[1]), 4, dtype=codes.dtype)])
        if lens is not None:
            lens = np.concatenate([np.asarray(lens), np.zeros(pad, dtype=np.int32)])
    return codes, lens


def count_read_kmers_sharded(chunks, ks, counter: ShardedCounter, batch_size: int) -> None:
    """The -M counter pass into a dp-sharded counter: bit-equal to one
    device's ``count_read_kmers`` (a ``counter.pass`` span)."""
    with span("counter.pass"):
        for chunk in chunks:
            for _, codes, lens in bucketed_batches(chunk, batch_size):
                counter.add_codes(*pad_rows(codes, lens, counter.mesh.dp), ks)


class ShardedCtx:
    """--devices N [--tp T] for stream and filter (``rkmh_tpu/commands/
    common.py:590``): the (dp, tp) grid over the first N of ``devices``,
    the panel's tp shards on it (``parallel/mesh.ShardedPanel``), the
    optional dp-sharded -M counter (``parallel/ep.ShardedCounter``) and
    the batch-row padding."""

    def __init__(self, panel: RefPanel, ks, devices: int, tp: int, counter_size: int,
                 batch_size: int, mesh_devices):
        self.ks = ks
        self.dp = devices // tp
        self.counter_size = counter_size
        self.batch_size = batch_size
        self.mesh = make_mesh(list(mesh_devices)[:devices], dp=self.dp, tp=tp)
        self.panel = ShardedPanel.from_sketches(self.mesh, panel.sketches.cpu().numpy(),
                                                panel.lens.cpu().numpy())
        self.counter: ShardedCounter | None = None  # set by build_counter (-M)

    def build_counter(self, pass1_chunks) -> None:
        """The -M first pass (rkmh.cpp:903-910) into the dp-sharded
        counter: bit-equal to one device's ``count_read_kmers``."""
        self.counter = ShardedCounter(self.mesh, self.counter_size)
        count_read_kmers_sharded(pass1_chunks, self.ks, self.counter, self.batch_size)

    def step(self, codes: np.ndarray, sketch_size: int, min_diff: int, min_matches: int,
             min_occ: int, filter_mode: bool = False) -> torch.Tensor:
        """One batch of host codes -> the [3, B] stream or [5, B] filter
        result of its real rows, on the grid's first device."""
        n = codes.shape[0]
        step = sharded_filter_step if filter_mode else sharded_classify_step
        return step(self.mesh, self.panel, pad_rows(codes, None, self.dp)[0], self.ks,
                    sketch_size, min_diff, min_matches, self.counter, min_occ)[:, :n]


def rows_in_order(parts) -> np.ndarray:
    """The row slices of a batch (tensors on any devices) as one host array."""
    arrs = [t.cpu().numpy() for t in parts]
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)


class DpCtx:
    """--devices N for the panel-less commands (hash, count, search;
    ``rkmh_tpu/commands/common.py:660``): a dp-only grid.  Each batch
    splits into dp row slices, each worked on its own device; the results
    are fetched in row order, so the text is byte-identical, and count's
    adds go into one table (addition commutes)."""

    def __init__(self, devices: int, mesh_devices):
        self.devices = devices
        self.mesh = make_mesh(list(mesh_devices)[:devices], dp=devices, tp=1)

    @classmethod
    def maybe(cls, devices: int, device: torch.device, mesh_devices=None) -> DpCtx | None:
        """A DpCtx when the geometry applies; None, with rkmh-tpu's logged
        fallback, when it does not."""
        if not devices or devices <= 1:
            return None
        candidates = mesh_candidates(device, mesh_devices)
        reason = sharded_geometry_reason(devices, 1, 1, len(candidates))
        if reason is not None:
            log(f"--devices ignored ({reason}); running single-device")
            return None
        return cls(devices, candidates)

    def round_batch(self, batch_size: int) -> int:
        """The batch size rounded up to a multiple of dp."""
        return -(-batch_size // self.devices) * self.devices

    def put(self, codes: np.ndarray, lens=None) -> list:
        """A host batch padded to a dp multiple (code 255, length 0: hashes
        to nothing) -> its dp row slices on their devices: [codes] or
        [(codes, lens)]."""
        pad = (-codes.shape[0]) % self.devices
        if pad:
            codes = np.concatenate([codes, np.full((pad, codes.shape[1]), 255, np.uint8)])
        out = [to_device(c, self.mesh[i, 0]) for i, c in enumerate(np.split(codes, self.devices))]
        if lens is None:
            return out
        lens = np.concatenate([np.asarray(lens, np.int32), np.zeros(pad, np.int32)])
        return [(c, to_device(n, c.device)) for c, n in zip(out, np.split(lens, self.devices))]
