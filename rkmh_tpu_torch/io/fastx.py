"""FASTA/FASTQ parsing — kseq-equivalent host-side reader.

A verbatim copy of ``rkmh_tpu/io/fastx.py`` (stdlib only).  It is copied
because importing any ``rkmh_tpu`` submodule runs ``rkmh_tpu/__init__.py``,
which imports and configures JAX; the port must run where JAX is absent.
The copy goes away once those import side effects move out of the package
``__init__`` (ROADMAP A0).

Records are (name, seq, qual) where name is the header token up to the
first whitespace (kseq semantics) and sequences are uppercased at parse
time exactly as rkmh's to_upper-at-parse does (rkmh.cpp:227).  Handles
multi-line FASTA, 4-line FASTQ, gzip (by magic bytes, not extension), and
streaming from stdin.  The port reads files with its native parser
(``io/native``); this one reads stdin and file objects, and is the
oracle the native parser is tested against.
"""

from __future__ import annotations

import gzip
import io
import sys
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    name: str
    seq: bytes  # uppercased
    qual: bytes | None = None


class _GzipWithRaw(gzip.GzipFile):
    """GzipFile that closes the underlying raw file too (GzipFile built
    from a fileobj otherwise leaks the descriptor)."""

    def close(self):
        raw = self.fileobj
        try:
            super().close()
        finally:
            if raw is not None:
                raw.close()


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return _GzipWithRaw(fileobj=f, mode="rb")
    return f


_UPPER = bytes(range(256)).upper()


def iter_fastx(source) -> Iterator[SeqRecord]:
    """Yield SeqRecords from a path, binary file object, or '-' (stdin)."""
    if isinstance(source, (str, bytes)):
        if source in ("-", b"-"):
            fh = sys.stdin.buffer
            close = False
        else:
            fh = _open_maybe_gzip(source)
            close = True
    else:
        fh = source
        close = False

    try:
        line = fh.readline()
        while line:
            line = line.rstrip(b"\r\n")
            if not line:
                line = fh.readline()
                continue
            if line.startswith(b">"):
                toks = line[1:].split(None, 1)
                name = toks[0].decode() if toks else ""
                chunks = []
                line = fh.readline()
                while line and not line.startswith((b">", b"@")):
                    chunks.append(line.rstrip(b"\r\n"))
                    line = fh.readline()
                yield SeqRecord(name, b"".join(chunks).translate(_UPPER))
            elif line.startswith(b"@"):
                toks = line[1:].split(None, 1)
                name = toks[0].decode() if toks else ""
                seq = fh.readline().rstrip(b"\r\n")
                plus = fh.readline()  # '+' separator
                if plus.startswith(b"+"):
                    qual = fh.readline().rstrip(b"\r\n")
                    line = fh.readline()
                else:
                    # plus-less '@' record: `plus` is the NEXT record's
                    # header — keep it as the lookahead instead of eating it
                    qual = None
                    line = plus
                yield SeqRecord(name, seq.translate(_UPPER), qual)
            else:
                raise ValueError(f"unrecognized FASTA/FASTQ line: {line[:50]!r}")
    finally:
        if close:
            fh.close()


def read_fastx(paths) -> list[SeqRecord]:
    """Parse one or many files, concatenated in order (rkmh repeats -f/-r)."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    out: list[SeqRecord] = []
    for p in paths:
        out.extend(iter_fastx(p))
    return out


def iter_batches(source, batch_size: int) -> Iterator[list[SeqRecord]]:
    """Buffered batch reading (KSEQ_Reader::get_next_buffer equivalent,
    rkmh.cpp:950-959 — the reference uses buffer_size 1000)."""
    batch: list[SeqRecord] = []
    for rec in iter_fastx(source):
        batch.append(rec)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
