"""`search` command — which reference k-mers each read holds.

Counterpart of ``rkmh_tpu/commands/search_cmd.py`` (``load_ref_kmers``
:56, ``run`` :70, the membership test :116-121) on one device.  The
reference files are text: token[0] of each line is hashed on the host at
its own length (``oracle.calc_hash``, rkmh.cpp:2191-2199), whatever k is.
Each read of at least k bases gets one line, ``name\\tkmer1,kmer2,...``:
its k-mers (at ``ks[0]``, in sequence order, as the read spells them)
whose canonical hash is a reference hash; a shorter read gets none.  As in
rkmh-tpu, the membership is exact: rkmh's own test compares every k-mer
against slot 1 of a lossy table (rkmh.cpp:2231).

On the device: K1 hashes the batch, then ``member_mask`` looks each hash
up in the sorted reference hashes (``torch.searchsorted`` on int64 bit
patterns with the sign bit flipped, so that the signed order is the
unsigned one, then a gather and a compare).  With ``-o FILE --resume`` the
lines already in FILE are dropped as they are made again
(``recovery.LineSkipWriter``), since a read shorter than k writes no line.
``--devices N`` (``commands.common.DpCtx``, rkmh_tpu/commands/
search_cmd.py:102-106) runs each of a batch's N row slices on its own
device, against a copy of the keys there, and fetches them in row order.
``--dist-*`` runs one rank of a multi-process search
(``commands/dist_stream.run_distributed_search``, rkmh_tpu/commands/
search_cmd.py:73-77).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch
from numpy.lib.stride_tricks import as_strided

from rkmh_tpu_torch import oracle
from rkmh_tpu_torch.commands.common import (
    DEFAULT_KMER,
    ChunkState,
    ChunkedPipeline,
    DpCtx,
    iter_packed_chunks,
    log,
    resolve_batch_size,
    resolve_chunk_reads,
    rows_in_order,
)
from rkmh_tpu_torch.commands.recovery import open_line_resume
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from rkmh_tpu_torch.observability import traced
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes
from rkmh_tpu_torch.ops.sketch import INT64_MIN
from rkmh_tpu_torch.parallel import distributed


@dataclass
class SearchConfig:
    ref_files: list = field(default_factory=list)   # text: a k-mer per line
    read_files: list = field(default_factory=list)  # FASTA/FASTQ
    ks: tuple = ()
    batch_size: int = 0             # 0 = auto (16384 on cuda, 2048 on cpu)
    chunk_reads: int = 0            # streaming window; 0 = default (65536)
    out_file: str = ""              # -o: lines here
    resume: bool = False            # --resume: line-counted append to -o
    devices: int = 0                # --devices: search over N devices (dp); 0 = one device
    device: str = DEFAULT_DEVICE
    mesh_devices: tuple | None = None  # the devices --devices takes (None: the visible ones)
    dist_coordinator: str = ""      # --dist-coordinator host:port
    dist_procs: int = 0             # --dist-procs: the number of processes
    dist_rank: int = -1             # --dist-rank: this process's rank


def load_ref_kmers(paths) -> np.ndarray:
    """Hash token[0] of every line of every ref file (rkmh.cpp:2191-2199):
    the distinct non-zero hashes, sorted ascending, as uint64."""
    hashes = set()
    for p in paths:
        with open(p) as fh:
            for line in fh:
                tok = line.split()
                if tok:
                    h = oracle.calc_hash(tok[0])
                    if h:
                        hashes.add(h)
    return np.asarray(sorted(hashes), dtype=np.uint64)


def sorted_keys(ref_hashes: np.ndarray, device) -> torch.Tensor:
    """uint64 hashes sorted ascending -> int64 keys ``h ^ INT64_MIN`` on
    ``device``, sorted ascending as signed integers."""
    return torch.from_numpy(ref_hashes.view(np.int64) ^ np.int64(INT64_MIN)).to(device)


def member_mask(hashes: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Each non-zero hash (int64 bit patterns) that is among the sorted
    keys (``sorted_keys``), as a bool tensor of the hashes' shape."""
    if keys.numel() == 0:
        return torch.zeros(hashes.shape, dtype=torch.bool, device=hashes.device)
    key = hashes ^ INT64_MIN
    pos = torch.searchsorted(keys, key).clamp_(max=keys.numel() - 1)
    return (keys[pos] == key) & (hashes != 0)


def _blob(chunk, field: str) -> tuple[bytes, np.ndarray]:
    """A chunk's names or sequences as (blob, [n + 1] absolute offsets):
    the native reader's own blob, or one made from the Python parser's
    list."""
    blob = getattr(chunk, f"_{field}s_blob", None)
    if blob is not None:
        return blob, getattr(chunk, f"_{field}_offs")
    items = [x.encode() if isinstance(x, str) else x for x in getattr(chunk, f"{field}s")]
    offs = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in items], out=offs[1:])
    return b"".join(items), offs


def format_search_lines(found: np.ndarray, lens: np.ndarray, k: int, rows: np.ndarray,
                        names: tuple, seqs: tuple) -> list[bytes]:
    """The output line of each row of a batch: for row i (chunk record
    rows[i], of length lens[i]) of a read of at least k bases,
    ``name\\tkmer,kmer,...\\n``, its k-mers at the windows ``found`` marks,
    in order; b"" for a shorter read.  ``names`` and ``seqs`` are the
    chunk's (blob, offsets).  The k-mers of the whole batch are cut from
    the sequence blob in one gather, each followed by "," or, the last of a
    line, by a newline."""
    name_blob, name_offs = names
    seq_blob, seq_offs = seqs
    nwin = np.maximum(lens.astype(np.int64) - k + 1, 0)
    found = found & (np.arange(found.shape[1])[None, :] < nwin[:, None])
    hit_row, hit_pos = np.nonzero(found)  # rows ascending, positions ascending in a row
    ends = (np.cumsum(np.bincount(hit_row, minlength=len(rows))) * (k + 1)).tolist()
    seq = np.frombuffer(seq_blob, np.uint8)
    windows = as_strided(seq, shape=(max(len(seq) - k + 1, 0), k), strides=(1, 1),
                         writeable=False)
    mers = np.empty((len(hit_row), k + 1), np.uint8)
    mers[:, :k] = windows[seq_offs[rows[hit_row]] + hit_pos]
    mers[:, k] = ord(",")
    mers[np.diff(hit_row, append=-1) != 0, k] = ord("\n")  # the last k-mer of a line
    mers = mers.tobytes()
    o = name_offs.tolist()
    lines, start = [], 0
    for r, end, w in zip(rows.tolist(), ends, nwin.tolist()):
        lines.append(b"" if w <= 0 else
                     name_blob[o[r]: o[r + 1]] + b"\t" + (mers[start:end] if end > start else b"\n"))
        start = end
    return lines


class _SearchChunk(ChunkState):
    """A chunk's name and sequence blobs and one line per row (empty for
    a read shorter than k), written in input order."""

    __slots__ = ("names", "seqs", "lines")

    def __init__(self, chunk):
        super().__init__(len(chunk))
        self.names = _blob(chunk, "name")
        self.seqs = _blob(chunk, "seq")
        self.lines = [b""] * self.n


@traced("search")
def run(cfg: SearchConfig, out=None) -> int:
    if distributed.requested(cfg.dist_procs, cfg.dist_coordinator):
        from rkmh_tpu_torch.commands.dist_stream import run_distributed_search

        return run_distributed_search(cfg, out)
    if cfg.resume and not cfg.out_file:
        log("search --resume requires -o/--out (resume state is the "
            "partial output itself); refusing to re-search to stdout")
        return 1
    if out is None and cfg.out_file:
        fh, wrapped = open_line_resume(cfg.out_file, cfg.resume)
        with fh:
            return _run(cfg, wrapped)
    return _run(cfg, out or sys.stdout)


def _run(cfg: SearchConfig, out) -> int:
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("Using default kmer size of 16.")
    k = ks[0]  # the reference k-merizes at kmer[0] only (rkmh.cpp:2228)

    ref_hashes = load_ref_kmers(cfg.ref_files)
    log(f"Loaded {len(ref_hashes)} reference kmers.")
    dpc = DpCtx.maybe(cfg.devices, device, cfg.mesh_devices)
    if dpc is not None:
        batch_size = dpc.round_batch(batch_size)
    keys = {}  # the sorted keys on each device a slice runs on

    def member(codes: torch.Tensor) -> torch.Tensor:
        if codes.device not in keys:
            keys[codes.device] = sorted_keys(ref_hashes, codes.device)
        return member_mask(kmer_window_hashes(codes, k), keys[codes.device])

    def dispatch(st, rows, codes, lens):
        parts = (dpc.put(codes) if dpc is not None
                 else [to_device(codes, device)])
        return (rows, lens), [member(c) for c in parts]

    def on_result(st, meta, found):
        rows, lens = meta
        found = found[: len(rows)]  # the pad rows of a dp split off
        for r, line in zip(rows.tolist(),
                           format_search_lines(found, lens, k, rows, st.names, st.seqs)):
            st.lines[r] = line
        st.filled += len(rows)

    pipeline = ChunkedPipeline(on_result=on_result,
                               emit=lambda st: out.write(b"".join(st.lines).decode()),
                               fetch=lambda results: [rows_in_order(r) for r in results])
    pipeline.run(iter_packed_chunks(cfg.read_files, resolve_chunk_reads(cfg.chunk_reads)),
                 make_state=_SearchChunk, dispatch=dispatch, batch_size=batch_size)
    return 0
