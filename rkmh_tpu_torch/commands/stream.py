"""`stream` / `classify` command — per-read MinHash classification.

Counterpart of ``rkmh_tpu/commands/stream.py`` (plain file path,
:428-645).  Output lines are byte-identical to ``rkmh-tpu stream``
(rkmh.cpp:891-893):

    ref \\t read \\t max_shared \\t sketch_size[FAIL:DEPTH] \\t [FAIL:MATCHES] \\t [FAIL:DIFF]

Not ported yet: -M / -I (the k-mer counters), -i (stdin streaming),
--devices / --tp, --dist-*, --resume and --ref-sketches.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from rkmh_tpu_torch.classify import engine
from rkmh_tpu_torch.commands.common import (
    DEFAULT_CHUNK_READS,
    DEFAULT_KMER,
    DEFAULT_SKETCH,
    ChunkState,
    ChunkedPipeline,
    build_ref_panel_from_files,
    iter_packed_chunks,
    log,
    resolve_batch_size,
)
from rkmh_tpu_torch.device import DEFAULT_DEVICE, resolve_device


@dataclass
class StreamConfig:
    ref_files: list = field(default_factory=list)
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    sketch_size: int = DEFAULT_SKETCH
    min_matches: int = -1        # -N
    min_diff: int = 0            # -D
    batch_size: int = 0          # 0 = auto (16384 on cuda, 2048 on cpu)
    chunk_reads: int = 0         # streaming window; 0 = default (65536)
    out_file: str = ""           # -o: write here instead of stdout
    device: str = DEFAULT_DEVICE


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


class _ChunkState(ChunkState):
    """Per-input-chunk output buffer: batches land in length-bucket order
    and the chunk is written in input order once every row has arrived."""

    __slots__ = ("names", "lines")

    def __init__(self, chunk):
        super().__init__(len(chunk))
        self.names = chunk.names  # only the names outlive the dispatch
        self.lines = [None] * self.n

    def render(self) -> str:
        return "".join(self.lines)


def run(cfg: StreamConfig, out=None) -> int:
    if out is None and cfg.out_file:
        with open(cfg.out_file, "w") as fh:
            return _run(cfg, fh)
    return _run(cfg, out or sys.stdout)


def _run(cfg: StreamConfig, out) -> int:
    device = resolve_device(cfg.device)
    batch_size = resolve_batch_size(cfg.batch_size, device)
    chunk_reads = cfg.chunk_reads if cfg.chunk_reads > 0 else DEFAULT_CHUNK_READS
    ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")

    panel = build_ref_panel_from_files(cfg.ref_files, ks, cfg.sketch_size, device)

    def dispatch(st, rows, codes, lens):
        batch = torch.from_numpy(codes).to(device, non_blocking=True)
        return rows, engine.classify_codes_table(
            batch, panel, ks, cfg.sketch_size, cfg.min_diff, cfg.min_matches)

    def fetch(results):
        return [r.cpu().numpy() for r in results]

    def on_result(st, rows, arr):
        lines = format_lines_host(panel.keys, [st.names[i] for i in rows], arr,
                                  cfg.sketch_size)
        for i, line in zip(rows.tolist(), lines):
            st.lines[i] = line
        st.filled += len(rows)

    pipeline = ChunkedPipeline(on_result=on_result,
                               emit=lambda st: out.write(st.render()), fetch=fetch)
    pipeline.run(iter_packed_chunks(cfg.read_files, chunk_reads), make_state=_ChunkState,
                 dispatch=dispatch, batch_size=batch_size)
    return 0
