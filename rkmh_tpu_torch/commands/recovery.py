"""Failure recovery for interrupted ``-o`` runs, as rkmh-tpu does it.

A copy of ``rkmh_tpu/commands/recovery.py`` (``InjectedFailure`` :42,
``fail_after_chunks`` :46, ``count_complete_lines`` :52, ``skip_reads``
:73, ``LineSkipWriter`` :96, ``open_line_resume`` :129, ``Progress``
:141).  Per-read output is deterministic, so an
interrupted run goes on by skipping the reads whose output already landed
and appending the rest; the result is byte-identical to an uninterrupted
run, and either package can resume an output of the other.  Two
mechanisms, by the command's output shape:

* line-counted (``stream``, ``hpv16``, ``hash``: one line per read;
  ``search``: one line per read of at least k bases, through
  ``LineSkipWriter``): the partial output is the checkpoint.  Its complete
  lines are counted and a torn last line is truncated away;
* the ``FILE.progress`` sidecar (``filter``, whose records are only those
  of the reads that pass): ``{"reads": N, "bytes": M}`` (reads consumed,
  output bytes), replaced atomically after each chunk's records are
  flushed; ``--resume`` truncates the output to M bytes and skips N reads.

Fault injection, to test the recovery end to end:
``RKMH_TPU_FAIL_AFTER_CHUNKS=N`` raises ``InjectedFailure`` after the N-th
chunk a ``stream``, ``filter`` or ``hpv16`` run emits, and after the N-th
reference ``call`` scans, where rkmh-tpu raises it, with its message.
``hash`` and ``search`` run to the end under it, as rkmh-tpu's do.
"""

from __future__ import annotations

import json
import os


class InjectedFailure(RuntimeError):
    """Raised where RKMH_TPU_FAIL_AFTER_CHUNKS trips."""


def fail_after_chunks() -> int:
    """The fault-injection threshold (0 = disabled)."""
    env = os.environ.get("RKMH_TPU_FAIL_AFTER_CHUNKS", "")
    return int(env) if env.isdigit() else 0


def count_complete_lines(path: str) -> int:
    """Newline-terminated lines in a partial output file (a torn final
    line without '\\n' is not counted and is truncated away so appends
    start on a line boundary)."""
    n = 0
    last_nl_end = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(1 << 20)
            if not block:
                break
            c = block.count(b"\n")
            if c:
                n += c
                last_nl_end = fh.tell() - (len(block) - block.rindex(b"\n") - 1)
    if os.path.getsize(path) != last_nl_end:
        with open(path, "r+b") as fh:
            fh.truncate(last_nl_end)
    return n


def skip_reads(chunk_iter, skip: int):
    """Drop the first `skip` reads from a packed-chunk iterator (whole
    chunks where possible, the rows after the boundary of the chunk it
    falls in: ``tail`` of a native ``PackedReads`` or a ``PyPacked``).
    Independent of the chunk size: resuming with another --chunk-reads
    still stitches byte-identically."""
    for chunk in chunk_iter:
        if skip == 0:
            yield chunk
            continue
        if len(chunk) <= skip:
            skip -= len(chunk)
            continue
        chunk, skip = chunk.tail(skip), 0
        yield chunk


class LineSkipWriter:
    """Drop the first `skip` output LINES, then pass writes through.

    The resume wrapper for commands whose per-read output is line-shaped
    but not exactly one line per read (`search` writes nothing for reads
    shorter than k): counting the lines already written and dropping that
    many again is right for any read -> lines mapping that is deterministic
    and in input order."""

    def __init__(self, out, skip: int):
        self.out = out
        self.skip = skip

    def write(self, s: str) -> None:
        if self.skip:
            while self.skip and s:
                nl = s.find("\n")
                if nl < 0:
                    raise ValueError(
                        "resume writer saw a partial line while skipping "
                        "(drains must write whole lines)")
                s = s[nl + 1:]
                self.skip -= 1
            if not s:
                return
        self.out.write(s)

    def flush(self) -> None:
        if hasattr(self.out, "flush"):
            self.out.flush()


def open_line_resume(out_file: str, resume: bool):
    """(file object, wrapped writer) for a line-shaped -o output: with
    resume and an existing file, append after the complete lines and
    wrap in a LineSkipWriter; otherwise truncate-open."""
    if resume and os.path.exists(out_file):
        skip = count_complete_lines(out_file)
        fh = open(out_file, "a")
        return fh, (LineSkipWriter(fh, skip) if skip else fh)
    fh = open(out_file, "w")
    return fh, fh


class Progress:
    """Atomic `<out>.progress` sidecar: {"reads": N, "bytes": M}.

    `save` is called after the owning command flushed its output, so the
    recorded byte size is always <= the on-disk output and everything up
    to it is final.  The sidecar is left behind on success (resuming a
    finished run is then a clean no-op append)."""

    def __init__(self, out_file: str):
        self.path = out_file + ".progress"

    def load(self) -> tuple[int, int] | None:
        """(reads_done, output_bytes) from the sidecar, or None when it
        is missing or unreadable (a filter output alone cannot say how
        far the input got)."""
        try:
            with open(self.path) as fh:
                d = json.load(fh)
            reads, nbytes = int(d["reads"]), int(d["bytes"])
        except (OSError, ValueError, KeyError):
            return None
        if reads < 0 or nbytes < 0:
            return None
        return reads, nbytes

    def save(self, reads_done: int, output_bytes: int) -> None:
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"reads": reads_done, "bytes": output_bytes}, fh)
        os.replace(tmp, self.path)
