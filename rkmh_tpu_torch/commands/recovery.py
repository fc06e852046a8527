"""Failure-recovery side files, as rkmh-tpu writes them.

A copy of ``Progress`` from ``rkmh_tpu/commands/recovery.py:141-170``:
``filter -o FILE`` writes records only for the reads that pass, so the
output's length says nothing about how far the input got.  After each
chunk's records are flushed, ``FILE.progress`` is replaced atomically by
``{"reads": N, "bytes": M}`` (reads consumed, output bytes), byte for byte
what rkmh-tpu writes, so that ``rkmh-tpu filter --resume`` can pick up a
run of this port.  ``--resume`` (and ``Progress.load``) is not ported yet.
"""

from __future__ import annotations

import json
import os


class Progress:
    """Atomic `<out>.progress` sidecar: {"reads": N, "bytes": M}.

    `save` is called after the owning command flushed its output, so the
    recorded byte size is always <= the on-disk output and everything up
    to it is final.  The sidecar is left behind on success."""

    def __init__(self, out_file: str):
        self.path = out_file + ".progress"

    def save(self, reads_done: int, output_bytes: int) -> None:
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"reads": reads_done, "bytes": output_bytes}, fh)
        os.replace(tmp, self.path)
