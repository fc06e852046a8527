"""`hash` command — per-read k-mer hashes, k-mers or sketches.

Counterpart of ``rkmh_tpu/commands/hash_cmd.py`` (``HashConfig`` :46,
``_wabbit_line`` :66, ``_multiset_counts`` :79, ``run`` :87) on one
device; output is byte-identical to ``rkmh-tpu hash``:

* default — one line per read, ``name\\th1 h2 ...``: every window's hash
  in sequence order as an unsigned decimal (0 for a window with a base
  other than ACGT), multi-k concatenated in k order;
* ``-s S`` — the read's bottom-S sketch (ascending, zeros dropped) in
  place of every hash;
* ``-K`` — one line per k-mer, ``kmer\\tname``, with no device pass;
* ``-w`` (with ``-c``: per-hash counts) — Vowpal Wabbit lines, the sorted
  non-zero hashes (or the sketch with ``-s``);
* ``--json`` / ``--sourmash`` / ``-o PREFIX`` — the sketches as one JSON
  document (``io/sketch_json``), to stdout or to PREFIX.rkmh.json or
  PREFIX.sig;
* ``--out FILE`` — the lines into FILE; with ``--resume`` a partial FILE's
  complete lines count the reads already hashed, and those are skipped at
  the input (every mode but -K and the JSON dumps).

K1 hashes each batch on the device (``engine.hash_batch_with_mask``, or
``engine.sketch_batch`` with -s); the lines of the default and -s modes
are formatted a batch at a time by the native formatter
(``rkmh_format_hash_lines``), the -w and JSON records in Python.  Hashes
come back as int64 bit patterns and are read as uint64 before any of them
becomes text.  ``--devices N`` (``commands.common.DpCtx``,
rkmh_tpu/commands/hash_cmd.py:138-142) hashes each of a batch's N row
slices on its own device and fetches them in row order.  ``--dist-*``
runs one rank of a multi-process drain
(``commands/dist_stream.run_distributed_hash``, rkmh_tpu/commands/
hash_cmd.py:90-94).
"""

from __future__ import annotations

import os
import sys
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import (
    DEFAULT_KMER,
    ChunkedPipeline,
    DpCtx,
    LinesChunk,
    iter_packed_chunks,
    log,
    resolve_batch_size,
    resolve_chunk_reads,
    rows_in_order,
)
from rkmh_tpu_torch.commands.recovery import count_complete_lines, skip_reads
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from rkmh_tpu_torch.io.native import format_hash_lines_block
from rkmh_tpu_torch.io.sketch_json import SketchRecord, dump_sketches, dump_sourmash
from rkmh_tpu_torch.observability import traced
from rkmh_tpu_torch.parallel import distributed


@dataclass
class HashConfig:
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    sketch_size: int = 0          # -s: 0 = every hash (rkmh's default)
    output_kmers: bool = False    # -K
    wabbitize: bool = False       # -w
    output_counts: bool = False   # -c: wabbit features carry multiset counts
    json_out: bool = False        # --json to stdout
    sourmash_out: bool = False    # --sourmash: sourmash_signature schema
    out_prefix: str = ""          # -o prefix -> prefix.rkmh.json / .sig
    batch_size: int = 0           # 0 = auto (16384 on cuda, 2048 on cpu)
    chunk_reads: int = 0          # streaming window; 0 = default (65536)
    out_file: str = ""            # --out: hash lines here
    resume: bool = False          # --resume: line-counted append to --out
    devices: int = 0              # --devices: hash over N devices (dp); 0 = one device
    device: str = DEFAULT_DEVICE
    mesh_devices: tuple | None = None  # the devices --devices takes (None: the visible ones)
    dist_coordinator: str = ""    # --dist-coordinator host:port
    dist_procs: int = 0           # --dist-procs: the number of processes
    dist_rank: int = -1           # --dist-rank: this process's rank


def _wabbit_line(name: str, mins: list[int], ks, sketch_size: int,
                 counts: list[int] | None = None,
                 label: str = "XYX", nspace: str = "vir") -> str:
    """print_wabbit format (rkmh.cpp:463-487); with counts (-c) the
    features carry per-hash counts instead of :1."""
    key = "_".join(name.split("|"))
    if counts:
        feats = " ".join(f"{m}:{c}" for m, c in zip(mins, counts))
    else:
        feats = " ".join(f"{m}:1" for m in mins)
    return f"{label} 1.0 `{key}|{nspace} {feats} |sketch k:{ks[0]} s:{sketch_size}\n"


def _multiset_counts(sorted_vals: list[int]) -> list[int]:
    """Per-element multiplicity of each value within the (sorted) list."""
    c = Counter(sorted_vals)
    return [c[v] for v in sorted_vals]


def _names_blob(names) -> tuple[bytes, np.ndarray]:
    """Names -> (one blob, [n + 1] offsets), the native formatter's input."""
    encoded = [n.encode() for n in names]
    offs = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offs[1:])
    return b"".join(encoded), offs


class _HashChunk(LinesChunk):
    """A chunk's lines (LinesChunk) or, for the JSON dumps, its records by
    row."""

    __slots__ = ("records",)

    def __init__(self, chunk):
        super().__init__(chunk)
        self.records = [None] * self.n


def hash_lines(cfg: HashConfig, ks, vals: np.ndarray, second: np.ndarray, names) -> str:
    """The default, -s and -w lines of a batch's rows: ``vals`` int64 [n,
    W] (hashes, or with -s the sketches), ``second`` the [n, W] window mask
    or, with -s, the [n] sketch lengths; ``names`` the rows' names (or,
    without -w, their (blob, n + 1 offsets)).  The native block formatter
    writes the default and -s lines."""
    vals = vals.view(np.uint64)
    sketch = cfg.sketch_size > 0
    mask = np.arange(vals.shape[1])[None, :] < second[:, None] if sketch else second
    if not cfg.wabbitize:
        blob = names if isinstance(names, tuple) else _names_blob(names)
        return format_hash_lines_block(vals, mask, *blob).decode()
    lines = []
    for j, name in enumerate(names):
        row = vals[j][mask[j]]
        mins = row.tolist() if sketch else np.sort(row[row != 0]).tolist()
        counts = _multiset_counts(mins) if cfg.output_counts else None
        lines.append(_wabbit_line(name, mins, ks, cfg.sketch_size, counts))
    return "".join(lines)


@traced("hash")
def run(cfg: HashConfig, out=None) -> int:
    if distributed.requested(cfg.dist_procs, cfg.dist_coordinator):
        from rkmh_tpu_torch.commands.dist_stream import run_distributed_hash

        return run_distributed_hash(cfg, out)
    if cfg.resume and not cfg.out_file:
        log("hash --resume requires -o/--out (resume state is the partial "
            "output itself); refusing to re-hash to stdout")
        return 1
    if out is None and cfg.out_file:
        if cfg.resume and (cfg.output_kmers or cfg.json_out
                           or cfg.sourmash_out or cfg.out_prefix):
            log("hash --resume supports the line-per-read output modes "
                "only (not -K or the JSON/sourmash dumps)")
            return 1
        if cfg.resume and os.path.exists(cfg.out_file):
            # one line per read in every mode resume takes: skip the reads
            # at the input, so no device work is done again
            skip = count_complete_lines(cfg.out_file)
            if skip:
                log(f"Resuming: {skip} reads already hashed in {cfg.out_file}")
            with open(cfg.out_file, "a") as fh:
                return _run(cfg, fh, skip)
        with open(cfg.out_file, "w") as fh:
            return _run(cfg, fh, 0)
    return _run(cfg, out or sys.stdout, 0)


def _run(cfg: HashConfig, out, resume_skip: int) -> int:
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("Using default kmer size of 16.")
    else:
        log(f"Using a kmer size of {ks[0]}")
    dpc = DpCtx.maybe(cfg.devices, device, cfg.mesh_devices)
    if dpc is not None:
        batch_size = dpc.round_batch(batch_size)
    want_json = cfg.json_out or cfg.sourmash_out or bool(cfg.out_prefix)
    chunks = iter_packed_chunks(cfg.read_files, resolve_chunk_reads(cfg.chunk_reads))
    if resume_skip:
        chunks = skip_reads(chunks, resume_skip)

    if cfg.output_kmers:
        # -K: raw k-mers need no device pass (rkmh.cpp:2078) and suppress
        # every other output mode
        k = ks[0]
        for chunk in chunks:
            for name, seq in zip(chunk.names, chunk.seqs):
                out.write("".join(f"{seq[i:i + k].decode()}\t{name}\n"
                                  for i in range(max(0, len(seq) - k + 1))))
        return 0

    sketch = cfg.sketch_size > 0

    def dispatch(st, rows, codes, lens):
        # the batch's row slices on their devices (one slice without --devices)
        parts = (dpc.put(codes, lens) if dpc is not None else
                 [(to_device(codes, device), to_device(lens, device))])
        if sketch:
            return (rows, lens), [engine.sketch_batch(c, ks, cfg.sketch_size) for c, _ in parts]
        return (rows, lens), [engine.hash_batch_with_mask(c, n, ks) for c, n in parts]

    def fetch(results):
        return [tuple(rows_in_order([part[t] for part in res]) for t in range(2))
                for res in results]

    def on_result(st, meta, arrs):
        rows, lens = meta
        arrs = [a[: len(rows)] for a in arrs]  # the pad rows of a dp split off
        contiguous = rows[-1] - rows[0] == len(rows) - 1
        if not want_json:
            names = ((st.chunk.blob, st.chunk.offs[rows[0]: rows[-1] + 2])
                     if st.chunk.blob is not None and contiguous and not cfg.wabbitize
                     else [st.chunk.names[i] for i in rows])
            text = hash_lines(cfg, ks, arrs[0], arrs[1], names)
            st.parts.append((int(rows[0]), text) if contiguous else
                            (rows.tolist(), [line + "\n" for line in text.split("\n")[:-1]]))
            st.filled += len(rows)
            return
        vals = arrs[0].view(np.uint64)
        for j, r in enumerate(rows.tolist()):
            row = vals[j][: arrs[1][j]] if sketch else vals[j][arrs[1][j]]
            mins = row.tolist() if sketch else np.sort(row[row != 0]).tolist()
            st.records[r] = SketchRecord(st.chunk.names[r], mins, list(ks), cfg.sketch_size,
                                         int(lens[j]))
        st.filled += len(rows)

    records: list[SketchRecord] = []

    def emit(st):
        if want_json:
            records.extend(st.records)
        else:
            out.write(st.render())

    pipeline = ChunkedPipeline(on_result=on_result, emit=emit, fetch=fetch)
    pipeline.run(chunks, make_state=_HashChunk, dispatch=dispatch, batch_size=batch_size)

    if want_json:
        writer, ext = ((dump_sourmash, ".sig") if cfg.sourmash_out
                       else (dump_sketches, ".rkmh.json"))
        if cfg.out_prefix:
            with open(f"{cfg.out_prefix}{ext}", "w") as fh:
                writer(records, fh)
            log(f"Wrote {len(records)} sketches to {cfg.out_prefix}{ext}")
        else:
            writer(records, out)
    return 0
