"""The benchmark's inputs, made with numpy from a seed.

A frozen copy of the port's synthetic workloads (``rkmh_tpu_torch/synth.py``
as of this benchmark's first version): the same draws in the same order, so
the same seed and sizes give byte-identical files, with the writers
rebuilt to assemble FASTQ and FASTA bytes as numpy arrays in place of
joined Python strings (2**20 reads of 150 bp in well under a second).
Later changes to the program's generator do not reach the yardstick.

A traffic's ``inputs`` names its generator, the module ``gen/<inputs>.py``,
whose ``write(out_dir, cfg, traffic, seed)`` writes one job's files into
``out_dir`` and returns their paths with the job's ``reads_n`` and
``bases``.  A new kind of input is a new module; this package holds what
the generators share (the FASTA and FASTQ writers) and ``make_inputs``.

* ``panel_reads`` (zika): reference genomes, each a mutant of one base
  genome, and equal-length short reads sampled from them.
* ``refpath_reads`` (hpv16): a PaVE-shaped refpath of type and sublineage
  genomes, and nanopore-like reads.
* ``call_sample`` (hpv16's call): HPV16REF, and nanopore-like reads of a
  sample with substitutions and deletions planted.
"""

from __future__ import annotations

import importlib
import os
import shutil

import numpy as np

ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def rng_seed(seed: int) -> int:
    """numpy takes non-negative seeds; a negative one maps to its 64-bit pattern."""
    return seed % (1 << 64)


# --- the writers --------------------------------------------------------------

def fasta_bytes(names, seqs, width: int = 70) -> bytes:
    """FASTA records, sequence lines of ``width`` bases."""
    parts = []
    for name, seq in zip(names, seqs):
        seq = np.asarray(seq, dtype=np.uint8)
        full = len(seq) // width
        rows = np.empty((full, width + 1), dtype=np.uint8)
        rows[:, :width] = seq[: full * width].reshape(full, width)
        rows[:, width] = 10
        parts += [b">%s\n" % name.encode(), rows.tobytes()]
        if len(seq) > full * width:
            parts += [seq[full * width:].tobytes(), b"\n"]
    return b"".join(parts)


def _digits(nums: np.ndarray, d: int) -> np.ndarray:
    """[n, d] ASCII decimal digits of numbers that all have d digits."""
    pw = 10 ** np.arange(d - 1, -1, -1, dtype=np.int64)
    return (nums[:, None] // pw % 10 + 48).astype(np.uint8)


def fastq_bytes_fixed(seqs: np.ndarray, first: int = 0) -> bytes:
    """FASTQ records of equal-length reads named read<i>, i = first, ...:
    the records of each name width are one [n, record] array."""
    n, L = seqs.shape
    out = []
    i = first
    while i < first + n:
        d = len(str(i))
        j = min(first + n, 10 ** d)  # the first number with d + 1 digits
        m = j - i
        rec = np.empty((m, 5 + d + 1 + L + 3 + L + 1), dtype=np.uint8)
        rec[:, :5] = np.frombuffer(b"@read", dtype=np.uint8)
        rec[:, 5: 5 + d] = _digits(np.arange(i, j, dtype=np.int64), d)
        c = 5 + d
        rec[:, c] = 10
        rec[:, c + 1: c + 1 + L] = seqs[i - first: j - first]
        c += 1 + L
        rec[:, c: c + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
        rec[:, c + 3: c + 3 + L] = ord("I")
        rec[:, -1] = 10
        out.append(rec.tobytes())
        i = j
    return b"".join(out)


def fastq_bytes(seqs, first: int = 0) -> bytes:
    """FASTQ records of reads of any lengths named read<i>: the bases and
    quality strings laid into one array around the headers."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    heads = [b"@read%d\n" % (first + i) for i in range(len(seqs))]
    hl = np.array([len(h) for h in heads], dtype=np.int64)
    rec = hl + 2 * lens + 4
    start = np.concatenate([[0], np.cumsum(rec)])
    out = np.empty(int(start[-1]), dtype=np.uint8)
    for i, (h, s) in enumerate(zip(heads, seqs)):
        a, b = int(start[i] + hl[i]), int(lens[i])
        out[start[i]: a] = np.frombuffer(h, dtype=np.uint8)
        out[a: a + b] = s
        out[a + b: a + b + 3] = (10, 43, 10)
        out[a + b + 3: a + 2 * b + 3] = 73
        out[a + 2 * b + 3] = 10
    return out.tobytes()


# --- a traffic's inputs -----------------------------------------------------------

def _sync(out_dir: str) -> None:
    """Flush the files of ``out_dir`` to the disk: their write-back then runs
    in set-up, and not in the measured window."""
    for name in os.listdir(out_dir):
        fd = os.open(os.path.join(out_dir, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def make_inputs(cfg: dict, traffic: dict, seed: int, cache_root: str) -> dict:
    """The files of one job of ``traffic`` under configuration ``cfg``, for
    ``seed``, written anew into ``cache_root/<inputs>/`` (what was there
    removed) and flushed to the disk: every run makes the same files from
    its seed and pays the same set-up for them."""
    kind = traffic["inputs"]
    out_dir = os.path.join(cache_root, kind)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    inputs = importlib.import_module(f"portbench.gen.{kind}").write(out_dir, cfg, traffic, seed)
    _sync(out_dir)
    return inputs
