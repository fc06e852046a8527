"""ctypes loader for the native FASTA/FASTQ parser, packer and formatter.

Counterpart of ``rkmh_tpu/io/native/__init__.py`` over a copy of its
source (``fastx_native.cpp`` here; see its header for what was left out).
Two differences:

* the library builds at first use with ``g++`` into ``rkmh_tpu_torch/_build/``
  (listed in ``.gitignore``), under a name keyed by a hash of the source,
  the compiler and its flags, written to a temporary name (the process's
  and thread's) and moved into place, so that several processes or
  threads can build it at once; no
  ``-march=native``, so a library built on one host runs on another;
* a failed build or load raises with the compiler's output: nothing falls
  back to the Python parser without being asked to.  Only the callers
  that take stdin or a file object use the Python parser (``io/fastx``),
  as rkmh-tpu does.

Nothing is built or loaded on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from rkmh_tpu_torch.observability import span

SOURCE = Path(__file__).resolve().parent / "fastx_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz",)
GRANULARITY = 128  # rows pad to a multiple of this, as io/packing.bucket_length's

_lib = None  # the loaded library, shared by every caller of this process
_load_lock = threading.Lock()  # one thread builds and loads; the others wait for it


class _RkmhBatch(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("pad_len", ctypes.c_int64),
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("lens", ctypes.POINTER(ctypes.c_int32)),
        ("names", ctypes.c_char_p),
        ("name_offs", ctypes.POINTER(ctypes.c_int64)),
        ("seqs", ctypes.c_char_p),
        ("seq_offs", ctypes.POINTER(ctypes.c_int64)),
        ("quals", ctypes.c_char_p),
        ("qual_offs", ctypes.POINTER(ctypes.c_int64)),
        ("rec_offs", ctypes.POINTER(ctypes.c_int64)),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librkmh_torch_io_{h.hexdigest()[:16]}.so"


def build(path: Path | None = None) -> Path:
    """Compile the source into the library at ``path`` (default:
    ``library_path()``); raises RuntimeError with the compiler's output if
    it fails."""
    path = library_path() if path is None else path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native io build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native io build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if this checkout has none."""
    if _lib is not None:
        return _lib
    with _load_lock:
        return _lib if _lib is not None else _load()


def _load() -> ctypes.CDLL:
    global _lib
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    _i64p = ctypes.POINTER(ctypes.c_int64)
    _out = ctypes.POINTER(ctypes.POINTER(ctypes.c_char))
    for name, argtypes, restype in (
        ("rkmh_read_fastx", [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_RkmhBatch)],
         ctypes.c_int),
        ("rkmh_free", [ctypes.POINTER(_RkmhBatch)], None),
        ("rkmh_stream_open", [ctypes.c_char_p], ctypes.c_void_p),
        ("rkmh_stream_next", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.POINTER(_RkmhBatch)], ctypes.c_int64),
        ("rkmh_stream_seek", [ctypes.c_void_p, ctypes.c_int64], ctypes.c_int),
        ("rkmh_stream_close", [ctypes.c_void_p], None),
        ("rkmh_format_lines", [_i64p, _i64p, _i64p, ctypes.c_int64, _i64p, ctypes.c_char_p,
                               _i64p, ctypes.c_char_p, _i64p, ctypes.c_int64, ctypes.c_char_p,
                               _i64p, _out], ctypes.c_int64),
        ("rkmh_format_hash_lines", [ctypes.POINTER(ctypes.c_uint64),
                                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_char_p, _i64p, _out],
         ctypes.c_int64),
        ("rkmh_buf_free", [ctypes.POINTER(ctypes.c_char)], None),
    ):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return _lib


def _i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def format_lines_block(arr, row_ids, names_blob: bytes, name_offs,
                       ref_blob: bytes, ref_offs,
                       tails_blob: bytes, tail_offs) -> bytes:
    """A [3, n] stream result (best, shared, flags) as one block of output
    bytes (``rkmh_format_lines``): line i is ref_key[best[i]] \\t
    name[row_ids[i]] \\t shared[i] tail[flags[i]].  ``row_ids`` maps result
    rows to records of names_blob/name_offs; None means the identity."""
    lib = load()
    best, shared, flags = (np.ascontiguousarray(a, dtype=np.int64) for a in arr[:3])
    name_offs = np.ascontiguousarray(name_offs, dtype=np.int64)
    ref_offs = np.ascontiguousarray(ref_offs, dtype=np.int64)
    tail_offs = np.ascontiguousarray(tail_offs, dtype=np.int64)
    if len(tail_offs) != 9:
        raise ValueError(f"format_lines_block takes 8 tails, got {len(tail_offs) - 1}")
    if row_ids is not None:
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int64)
        if len(row_ids) != len(best):
            raise ValueError(f"format_lines_block: {len(row_ids)} row ids for {len(best)} rows")
        if len(row_ids) and (row_ids.min() < 0 or row_ids.max() >= len(name_offs) - 1):
            raise ValueError("format_lines_block: a row id outside the name table")
    elif len(best) > len(name_offs) - 1:
        raise ValueError(f"format_lines_block: {len(best)} rows for {len(name_offs) - 1} names")
    out = ctypes.POINTER(ctypes.c_char)()
    ln = lib.rkmh_format_lines(
        _i64_ptr(best), _i64_ptr(shared), _i64_ptr(flags), len(best),
        _i64_ptr(row_ids) if row_ids is not None else None,
        names_blob, _i64_ptr(name_offs), ref_blob, _i64_ptr(ref_offs), len(ref_offs) - 1,
        tails_blob, _i64_ptr(tail_offs), ctypes.byref(out))
    if ln < 0:
        raise MemoryError("format_lines_block: the native formatter could not allocate "
                          "its buffer")
    try:
        return ctypes.string_at(out, ln)
    finally:
        lib.rkmh_buf_free(out)


def format_hash_lines_block(vals, mask, names_blob: bytes, name_offs) -> bytes:
    """A hash-dump batch as one block of output bytes
    (``rkmh_format_hash_lines``; the JAX package's binding is
    ``rkmh_tpu/io/native/__init__.py:117``): line i is name i, a tab, and
    the masked-in values of row i as unsigned decimals joined by spaces.
    ``vals`` [n, W] holds uint64 bit patterns (int64 or uint64), ``mask``
    [n, W] bool; name i is names_blob[name_offs[i]:name_offs[i + 1]]
    (absolute offsets, n + 1 of them)."""
    lib = load()
    vals = np.ascontiguousarray(vals).view(np.uint64)
    mask = np.ascontiguousarray(mask, dtype=np.bool_).view(np.uint8)
    name_offs = np.ascontiguousarray(name_offs, dtype=np.int64)
    if vals.ndim != 2 or mask.shape != vals.shape:
        raise ValueError(f"format_hash_lines_block: values {vals.shape} and mask "
                         f"{mask.shape} are not one [n, W] shape")
    n, W = vals.shape
    if len(name_offs) != n + 1 or (n and (name_offs[0] < 0 or name_offs[-1] > len(names_blob)
                                          or np.any(np.diff(name_offs) < 0))):
        raise ValueError(f"format_hash_lines_block: {len(name_offs)} name offsets for {n} "
                         f"rows in a {len(names_blob)}-byte blob")
    out = ctypes.POINTER(ctypes.c_char)()
    ln = lib.rkmh_format_hash_lines(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, W, names_blob,
        _i64_ptr(name_offs), ctypes.byref(out))
    if ln < 0:
        raise MemoryError("format_hash_lines_block: the native formatter could not allocate "
                          "its buffer")
    try:
        return ctypes.string_at(out, ln)
    finally:
        lib.rkmh_buf_free(out)


class PackedReads:
    """A parsed chunk as the device steps take it: codes [n, L] uint8 and
    lens [n] int32, each record's start offset (``rec_offs``), and the raw
    record bytes as blobs.  names, seqs and quals (None for FASTA) become
    Python objects only when first read: stream and hpv16 read names
    alone, filter's record output all three."""

    __slots__ = (
        "codes", "lens", "rec_offs",
        "_names_blob", "_name_offs", "_seqs_blob", "_seq_offs",
        "_quals_blob", "_qual_offs", "_names", "_seqs", "_quals",
    )

    def __init__(self, codes, lens, names_blob, name_offs, seqs_blob,
                 seq_offs, quals_blob, qual_offs, rec_offs):
        self.codes = codes
        self.lens = lens
        self.rec_offs = rec_offs
        self._names_blob = names_blob
        self._name_offs = name_offs
        self._seqs_blob = seqs_blob
        self._seq_offs = seq_offs
        self._quals_blob = quals_blob
        self._qual_offs = qual_offs
        self._names = self._seqs = self._quals = None

    def __len__(self):
        return len(self.lens)

    def tail(self, start: int) -> PackedReads:
        """The records from ``start`` on (a resumed run's first chunk).  The
        blobs are shared; their offsets stay absolute."""
        return PackedReads(self.codes[start:], self.lens[start:], self._names_blob,
                           self._name_offs[start:], self._seqs_blob, self._seq_offs[start:],
                           self._quals_blob, self._qual_offs[start:], self.rec_offs[start:])

    @staticmethod
    def _split(blob: bytes, offs) -> list[bytes]:
        o = offs.tolist()
        return [blob[o[i]: o[i + 1]] for i in range(len(o) - 1)]

    @property
    def names(self) -> list[str]:
        if self._names is None:
            self._names = [b.decode() for b in self._split(self._names_blob, self._name_offs)]
        return self._names

    @property
    def seqs(self) -> list[bytes]:
        if self._seqs is None:
            self._seqs = self._split(self._seqs_blob, self._seq_offs)
        return self._seqs

    @property
    def quals(self) -> list:
        if self._quals is None:
            self._quals = [q or None for q in self._split(self._quals_blob, self._qual_offs)]
        return self._quals


def _batch_to_packed(lib, batch: _RkmhBatch) -> PackedReads:
    """Copy an owned _RkmhBatch into numpy arrays and bytes, and free it
    (an ``input.unpack`` span: the copies hold the interpreter lock)."""
    with span("input.unpack"):
        try:
            n, pad = batch.n, batch.pad_len

            def arr(ptr, count):
                return np.ctypeslib.as_array(ptr, shape=(count,)).copy()

            codes = (np.ctypeslib.as_array(batch.codes, shape=(n, pad)).copy() if n
                     else np.zeros((0, pad), np.uint8))
            lens = arr(batch.lens, n) if n else np.zeros((0,), np.int32)
            rec_offs = arr(batch.rec_offs, n) if n else np.zeros((0,), np.int64)
            name_offs, seq_offs, qual_offs = (arr(p, n + 1) for p in (
                batch.name_offs, batch.seq_offs, batch.qual_offs))
            names_blob, seqs_blob, quals_blob = (
                ctypes.string_at(p, int(o[n])) if n else b""
                for p, o in ((batch.names, name_offs), (batch.seqs, seq_offs),
                             (batch.quals, qual_offs)))
        finally:
            lib.rkmh_free(ctypes.byref(batch))
        return PackedReads(codes, lens, names_blob, name_offs, seqs_blob, seq_offs, quals_blob,
                           qual_offs, rec_offs)


_PARSE_ERRORS = {1: "cannot read", 2: "malformed FASTA/FASTQ", 3: "out of memory"}


def _open_check(path) -> None:
    """Raise what the Python parser's open() raises for a path it cannot
    read (FileNotFoundError, IsADirectoryError, PermissionError), which the
    CLI reports as such."""
    with open(path, "rb"):
        pass


def read_fastx_packed(path) -> PackedReads:
    """Parse and pack one whole file natively (an ``input.parse`` span)."""
    lib = load()
    _open_check(path)
    with span("input.parse"):
        batch = _RkmhBatch()
        rc = lib.rkmh_read_fastx(os.fsencode(path), GRANULARITY, ctypes.byref(batch))
        if rc != 0:
            lib.rkmh_free(ctypes.byref(batch))
            raise OSError(f"native fastx parse of {path} failed: {_PARSE_ERRORS.get(rc, rc)}")
        return _batch_to_packed(lib, batch)


class FastxStream:
    """The chunked native reader (KSEQ_Reader::get_next_buffer,
    rkmh.cpp:950-959): memory bounded whatever the file's size.  Each
    ``next_chunk(max_reads)`` returns a PackedReads of at most max_reads
    records, or None at the end of the file."""

    def __init__(self, path):
        self._h = None
        self._lib = load()
        self._path = path
        _open_check(path)
        self._h = self._lib.rkmh_stream_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open {path}")

    def next_chunk(self, max_reads: int) -> PackedReads | None:
        """The next chunk, in an ``input.parse`` span (the native parse, then
        ``input.unpack``)."""
        if self._h is None:
            raise OSError(f"{self._path}: stream closed")
        with span("input.parse"):
            batch = _RkmhBatch()
            n = self._lib.rkmh_stream_next(self._h, max_reads, GRANULARITY, ctypes.byref(batch))
            if n <= 0:
                self._lib.rkmh_free(ctypes.byref(batch))
                if n < 0:
                    raise OSError(f"native fastx parse of {self._path} failed: "
                                  f"{_PARSE_ERRORS.get(-n, n)}")
                return None
            return _batch_to_packed(self._lib, batch)

    def seek(self, offset: int) -> None:
        """Go to an absolute offset of the uncompressed stream, a record
        start (``PackedReads.rec_offs``); the next chunk starts there.  On
        a gzip file zlib decompresses up to the offset."""
        if self._h is None:
            raise OSError(f"{self._path}: stream closed")
        if self._lib.rkmh_stream_seek(self._h, int(offset)) != 0:
            raise OSError(f"seek({offset}) failed for {self._path}")

    def close(self) -> None:
        if self._h is not None:
            self._lib.rkmh_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
