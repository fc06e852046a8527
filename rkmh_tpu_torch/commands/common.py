"""Shared command plumbing: the reference panel, input chunks, batching and
the pipelined dispatch/fetch/emit loop.

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

import sys
from collections import deque

import numpy as np
import torch
from torch import nn

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.io.fastx import iter_batches, read_fastx
from rkmh_tpu_torch.io.packing import encode_seqs, length_buckets
from rkmh_tpu_torch.ops.lookup import build_panel_table

DEFAULT_KMER = 16          # rkmh.cpp:728-731
DEFAULT_SKETCH = 1000      # rkmh.cpp:592
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


def build_ref_panel(ref_packed, ks, sketch_size: int, device: torch.device) -> RefPanel:
    """Hash and sketch a parsed panel on ``device``, then build its table
    on the host (numpy, identical to the JAX package's builder)."""
    codes = torch.from_numpy(ref_packed.codes).to(device)
    sk, sk_lens = engine.sketch_batch(codes, ks, sketch_size)
    pt = build_panel_table(sk.cpu().numpy(), sk_lens.cpu().numpy())
    table = torch.from_numpy(pt.table.view(np.int32)).to(device)
    return RefPanel(ref_packed.names, sk, sk_lens, table)


def build_ref_panel_from_files(ref_files, ks, sketch_size: int,
                               device: torch.device) -> RefPanel:
    """build_ref_panel over files parsed and concatenated in order."""
    return build_ref_panel(PyPacked(read_fastx(ref_files)), ks, sketch_size, device)


class PyPacked:
    """Parsed records as [N, L] codes + lengths + names."""

    def __init__(self, records):
        self.codes, self.lens = encode_seqs([r.seq for r in records])
        self.names = [r.name for r in records]

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


def iter_packed_chunks(paths, chunk_reads: int):
    """Yield PyPacked chunks of <= chunk_reads records, files in order
    (chunks never span files), so only one parsed chunk is resident."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    for p in paths:
        for recs in iter_batches(p, chunk_reads):
            yield PyPacked(recs)


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

    Dispatches are asynchronous on the device; up to 2 * FETCH_GROUP batch
    results stay in flight and are fetched FETCH_GROUP at a time.  Chunks are
    emitted in input order the moment they complete, so residency is the
    in-flight window plus ~2 chunks, whatever the input size.

    on_result(state, meta, host_array): record one batch's fetched result
        into its chunk state and advance state.filled.
    emit(state): write one completed chunk's output.
    fetch(device_results) -> host arrays, in order.
    """

    def __init__(self, on_result, emit, fetch):
        self.on_result = on_result
        self.emit = emit
        self.fetch = fetch
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
                if len(self.pending) > 2 * FETCH_GROUP:
                    self._flush(FETCH_GROUP)
            st.dispatched = True
        while self.pending:
            self._flush(len(self.pending))
        self._drain()
