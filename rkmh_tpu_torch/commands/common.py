"""Shared command plumbing: the reference panel, input chunks, the -M
counter pass, batching and the pipelined dispatch/fetch/emit loop.

Counterpart of ``rkmh_tpu/commands/common.py:17-553``.  Differences:

* the panel is an ``nn.Module`` whose tables are buffers, built on the
  requested device; the on-disk panel cache is not ported yet;
* input goes through the Python parser (``io/fastx``); the native C++
  parser of ``rkmh_tpu/io/native`` is not reused yet;
* batches are not padded to powers of two: that padding only bounded the
  number of XLA compilations, and eager PyTorch compiles nothing;
* ``ChunkedPipeline`` takes the fetch function as an argument.
"""

from __future__ import annotations

import os
import stat
import sys
from collections import deque

import numpy as np
import torch
from torch import nn

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.io.fastx import iter_batches, read_fastx
from rkmh_tpu_torch.io.packing import encode_seqs, length_buckets
from rkmh_tpu_torch.ops.counter import HashCounter
from rkmh_tpu_torch.ops.hashing import multi_k_window_hashes
from rkmh_tpu_torch.ops.lookup import build_panel_table

DEFAULT_KMER = 16          # rkmh.cpp:728-731
DEFAULT_SKETCH = 1000      # rkmh.cpp:592
DEFAULT_COUNTER_SIZE = 200_000_000  # stream's counters, rkmh.cpp:739-742
DEFAULT_BATCH_CPU = 2048
DEFAULT_BATCH_CUDA = 16384
DEFAULT_CHUNK_READS = 65536
FETCH_GROUP = 4            # results fetched per host sync; not tuned yet
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
    bucket table [NB, S*(3+Wm)] int32 the probe queries."""

    def __init__(self, keys, sketches: torch.Tensor, lens: torch.Tensor,
                 table: torch.Tensor):
        super().__init__()
        self.keys = list(keys)
        self.register_buffer("sketches", sketches)
        self.register_buffer("lens", lens)
        self.register_buffer("table", table)

    @property
    def num_refs(self) -> int:
        return len(self.keys)


def build_ref_panel(ref_packed, ks, sketch_size: int, device: torch.device,
                    max_samples: int | None = None,
                    counter_size: int = DEFAULT_COUNTER_SIZE,
                    distinct_counter: bool = False) -> RefPanel:
    """Hash and sketch a parsed panel on ``device``, then build its table
    on the host (numpy, identical to the JAX package's builder).

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
    pt = build_panel_table(sk.cpu().numpy(), sk_lens.cpu().numpy())
    table = torch.from_numpy(pt.table.view(np.int32)).to(device)
    return RefPanel(ref_packed.names, sk, sk_lens, table)


def build_ref_panel_from_files(ref_files, ks, sketch_size: int, device: torch.device,
                               **counter_kw) -> RefPanel:
    """build_ref_panel over files parsed and concatenated in order;
    counter_kw are build_ref_panel's -I arguments."""
    return build_ref_panel(PyPacked(read_fastx(ref_files)), ks, sketch_size, device,
                           **counter_kw)


class PyPacked:
    """Parsed records as [N, L] codes + lengths + names, and the raw
    sequences and qualities (None for FASTA) that filter re-emits."""

    def __init__(self, records):
        self.codes, self.lens = encode_seqs([r.seq for r in records])
        self.names = [r.name for r in records]
        self.seqs = [r.seq for r in records]
        self.quals = [r.qual for r in records]

    def __len__(self):
        return len(self.names)


def load_packed(paths) -> PyPacked:
    """Parse files, concatenated in order, into one PyPacked
    (``rkmh_tpu/commands/common.py:237``; the padded width may differ from
    the JAX package's per-file packing, which only moves padding)."""
    return PyPacked(read_fastx(paths))


def resolve_chunk_reads(requested: int) -> int:
    """Reads per parsed chunk; 0 = the default (65536)."""
    return requested if requested and requested > 0 else DEFAULT_CHUNK_READS


def _as_list(paths) -> list:
    """A single path or file object -> [it]; a list or tuple as it is."""
    return list(paths) if isinstance(paths, (list, tuple)) else [paths]


def iter_packed_chunks(paths, chunk_reads: int):
    """Yield PyPacked chunks of <= chunk_reads records, files in order
    (chunks never span files), so only one parsed chunk is resident.
    ``paths`` holds paths, ``-`` (stdin) or binary file objects."""
    for p in _as_list(paths):
        for recs in iter_batches(p, chunk_reads):
            yield PyPacked(recs)


def _rereadable(p) -> bool:
    if not isinstance(p, (str, bytes)) or p in ("-", b"-"):
        return False
    try:
        return not stat.S_ISFIFO(os.stat(p).st_mode)
    except OSError:
        return True  # let the parser raise the error for a missing file


def two_pass_chunks(paths, chunk_reads: int):
    """(first-pass iterable, second-pass factory) over PyPacked chunks,
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
                     device: torch.device) -> HashCounter:
    """The -M counter pass: every window of every read (hash 0 of an
    invalid k-mer included, padding excluded) into a new ``hash %
    counter_size`` counter on ``device`` (rkmh.cpp:903-910)."""
    counter = HashCounter(counter_size, device)
    for chunk in chunks:
        for _, codes, lens in bucketed_batches(chunk, batch_size):
            batch = torch.from_numpy(codes).to(device, non_blocking=True)
            counter.add_windows(multi_k_window_hashes(batch, ks),
                                torch.from_numpy(lens).to(device, non_blocking=True),
                                batch.shape[1], ks)
    return counter


def bucketed_batches(packed, batch_size: int):
    """Yield (rows [B] indices into the chunk, codes [B, Lb], lens [B])
    grouped by padded-length bucket (``io.packing.length_buckets``), so a
    length-spread input pads each read only to its bucket's length."""
    if len(packed) == 0:
        return
    uniq, bidx = length_buckets(packed.lens, MAX_LENGTH_BUCKETS)
    for b, Lb in enumerate(uniq):
        sel = np.nonzero(bidx == b)[0]
        for off in range(0, len(sel), batch_size):
            rows = sel[off : off + batch_size]
            yield rows, packed.codes[rows][:, : int(Lb)], packed.lens[rows]


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


class ChunkedPipeline:
    """Dispatch -> grouped fetch -> in-order emit.

    Dispatches are asynchronous on the device; up to 2 * group batch
    results stay in flight and are fetched group at a time (FETCH_GROUP by
    default).  Chunks are emitted in input order the moment they complete,
    so residency is the in-flight window plus ~2 chunks, whatever the input
    size.

    on_result(state, meta, host_array): record one batch's fetched result
        into its chunk state and advance state.filled.
    emit(state): write one completed chunk's output.
    fetch(device_results) -> host arrays, in order.
    """

    def __init__(self, on_result, emit, fetch, group: int = FETCH_GROUP):
        self.on_result = on_result
        self.emit = emit
        self.fetch = fetch
        self.group = group
        self.pending = deque()   # (state, meta, device_result)
        self.emit_q = deque()    # chunk states in input order

    def _drain(self):
        while self.emit_q and self.emit_q[0].complete:
            self.emit(self.emit_q.popleft())

    def _flush(self, n: int):
        group = [self.pending.popleft() for _ in range(min(n, len(self.pending)))]
        fetched = self.fetch([res for *_, res in group])
        for (st, meta, _), arr in zip(group, fetched):
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
