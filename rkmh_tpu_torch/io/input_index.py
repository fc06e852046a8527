"""Input-index cache for the --dist-* drains.

A copy of ``rkmh_tpu/io/input_index.py:1-262`` over the port's native
reader (``io/native``: ``FastxStream.seek``, ``PackedReads.rec_offs``).
The cache directory, the entry's key (``index_path``), its npz fields,
``_VERSION``, the fingerprint and the GC are rkmh-tpu's, so an entry
either package writes loads in the other.  One difference: the port's
native reader raises when it cannot be built (``io/native``), so
``is_indexable`` does not answer False for a missing library; it raises
as every other file read does.

The reference buffers its whole input in memory and never re-reads it
(rkmh.cpp:783-788); the multi-host drains instead re-parse the input up
to 3x per host (counting pre-pass, optional -M pass, classify pass) to
keep memory bounded.  The index removes that wart: it records every
record's start byte offset (uncompressed stream) and sequence length,
so

* the counting pre-pass is answered from the index (O(1) instead of a
  full parse) on every run after the first, and
* each rank **seeks** to the records it owns per global batch instead
  of parsing the whole file — O(N/H) parse work per pass per host.

Index entries are content-addressed into ``~/.cache/rkmh_tpu/idx/`` by
the input's absolute path (same recipe as the panel cache,
commands/common._panel_cache_path) — NEVER written next to the input,
so read-only data directories stay pristine.  Entries are fingerprinted
against (file size, mtime_ns) and rebuilt on any mismatch; a
missing/stale/unwritable entry only costs the old full-parse behavior,
never correctness.  Gzip inputs are never indexed (gzseek decompresses
forward, erasing the win) and neither is the pure-python parser path
(no byte offsets) — both fall back to the full parse.  Set
``RKMH_TPU_INPUT_INDEX=0`` to disable, or to a directory to relocate
the cache.

The fingerprint folds in a CONTENT SAMPLE (hash of the first+last 64 KB)
on top of (size, mtime_ns): a ``cp -p``/``rsync -t``-style replacement
that preserves size and mtime, or two multi-host machines sharing a home
with different file content at the same path, would otherwise silently
serve a stale index and parse the wrong records.  The cache also GCs
itself on writes: entries whose recorded source path no longer exists
are dropped, and the newest ``RKMH_TPU_INPUT_INDEX_MAX`` (default 512)
entries are kept beyond that.
"""

from __future__ import annotations

import os

import numpy as np

_VERSION = 2
_SAMPLE = 1 << 16  # content-sample window at each end of the file


def enabled() -> bool:
    return os.environ.get("RKMH_TPU_INPUT_INDEX", "1") != "0"


def index_path(path) -> str:
    """Cache entry for this input, keyed by its absolute path."""
    import hashlib

    env = os.environ.get("RKMH_TPU_INPUT_INDEX", "")
    cache_dir = env if env not in ("", "0", "1") else os.path.join(
        os.path.expanduser("~"), ".cache", "rkmh_tpu", "idx")
    key = hashlib.sha256(
        os.path.abspath(os.fspath(path)).encode()).hexdigest()[:32]
    return os.path.join(cache_dir, f"{key}.idx.npz")


def _fingerprint(path):
    """(size, mtime_ns, content-sample hash).  The sample hashes the
    first and last 64 KB, so a same-size timestamp-preserving content
    swap still invalidates the entry while the check stays O(1) in the
    file size."""
    import hashlib

    st = os.stat(path)
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as fh:
        h.update(fh.read(_SAMPLE))
        if st.st_size > _SAMPLE:
            fh.seek(max(st.st_size - _SAMPLE, 0))
            h.update(fh.read(_SAMPLE))
    return int(st.st_size), int(st.st_mtime_ns), h.hexdigest()


def is_indexable(path) -> bool:
    """Plain (non-gzip) regular file readable by the native parser."""
    if not isinstance(path, (str, bytes)) or path in ("-", b"-"):
        return False
    from rkmh_tpu_torch.io.native import load

    load()  # raises if the reader cannot be built: nothing falls back to Python
    try:
        with open(path, "rb") as fh:
            magic = fh.read(2)
    except OSError:
        return False
    return magic != b"\x1f\x8b"


def save_index(path, offs: np.ndarray, lens: np.ndarray) -> bool:
    """Write the cache entry atomically (tmp + rename: concurrent hosts
    sharing a home write identical content, so last-writer wins is
    benign and a killed writer never leaves a torn file).  Best-effort:
    an unwritable cache dir just skips the entry."""
    idx = index_path(path)
    tmp = f"{idx}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(idx), exist_ok=True)
        size, mtime_ns, content = _fingerprint(path)
        with open(tmp, "wb") as fh:
            np.savez(fh,
                     version=np.int64(_VERSION),
                     size=np.int64(size), mtime_ns=np.int64(mtime_ns),
                     content=np.str_(content),
                     src=np.str_(os.path.abspath(os.fspath(path))),
                     offs=np.asarray(offs, np.int64),
                     lens=np.asarray(lens, np.int32))
        os.replace(tmp, idx)
        # src sidecar: lets the GC check liveness without np.loading
        # every entry (the npz keeps src too, as the fallback)
        try:
            with open(idx[: -len(".npz")] + ".src", "w") as fh:
                fh.write(os.path.abspath(os.fspath(path)))
        except OSError:
            pass
        _gc(os.path.dirname(idx))
        return True
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _max_entries() -> int:
    try:
        return int(os.environ.get("RKMH_TPU_INPUT_INDEX_MAX", "512"))
    except ValueError:
        return 512


def _entry_src(p: str) -> str:
    """The recorded source path of a cache entry: the cheap .src
    sidecar when present (GC reads every entry, so avoid np.loading
    ~cap zip files per save), else the npz field."""
    try:
        with open(p[: -len(".npz")] + ".src") as fh:
            return fh.read().strip()
    except OSError:
        pass
    try:
        with np.load(p) as z:
            return str(z["src"]) if "src" in z.files else ""
    except (OSError, ValueError, KeyError, EOFError):
        return ""


def _rm_entry(p: str) -> None:
    for path in (p, p[: -len(".npz")] + ".src"):
        try:
            os.remove(path)
        except OSError:
            pass


def _gc(cache_dir) -> None:
    """Bound the cache: past the entry cap, drop entries whose recorded
    source no longer exists (tmp-dir inputs from tests and one-off runs
    would otherwise accumulate forever), then the least recently USED
    (load_index bumps an entry's mtime on every hit, so recency is use,
    not build time).  Best-effort — any racing deletion/unreadability
    is ignored."""
    cap = _max_entries()
    try:
        names = [n for n in os.listdir(cache_dir) if n.endswith(".idx.npz")]
    except OSError:
        return
    if len(names) <= cap:
        return
    survivors = []
    for n in names:
        p = os.path.join(cache_dir, n)
        src = _entry_src(p)
        if not src or not os.path.exists(src):
            _rm_entry(p)
            continue
        try:
            survivors.append((os.stat(p).st_mtime_ns, p))
        except OSError:
            pass
    survivors.sort(reverse=True)
    for _, p in survivors[cap:]:
        _rm_entry(p)


def load_index(path):
    """(offs, lens) from a fresh cache entry, else None (missing,
    unreadable, version bump, or the input changed since it was
    written)."""
    try:
        size, mtime_ns, content = _fingerprint(path)
        idx = index_path(path)
        with np.load(idx) as z:
            if int(z["version"]) != _VERSION:
                return None
            if (int(z["size"]), int(z["mtime_ns"]),
                    str(z["content"])) != (size, mtime_ns, content):
                return None
            out = z["offs"].astype(np.int64), z["lens"].astype(np.int32)
        try:
            os.utime(idx)  # recency for the GC's LRU = last USE
        except OSError:
            pass
        return out
    except (OSError, KeyError, ValueError):
        return None


def scan_or_index(read_files, chunk_reads: int):
    """The distributed counting pre-pass: (N, maxlen, per-file index).

    Per file: load a fresh cache entry, else parse it (bounded chunks) —
    collecting offsets when the native parser provides them — and save
    the entry for every later pass/run.  The per-file index list holds
    (offs, lens) or None (unindexable file); callers use it only when
    every entry is present.
    """
    from rkmh_tpu_torch.commands.common import iter_packed_chunks

    if isinstance(read_files, (str, bytes)) or not isinstance(
            read_files, (list, tuple)):
        read_files = [read_files]
    index = []
    n_total, maxlen = 0, 0
    for p in read_files:
        indexable = enabled() and is_indexable(p)
        entry = load_index(p) if indexable else None
        if entry is None:
            offs_parts, lens_parts = [], []
            have_offs = indexable
            for chunk in iter_packed_chunks([p], chunk_reads):
                lens_parts.append(np.asarray(chunk.lens, np.int32))
                ro = getattr(chunk, "rec_offs", None)
                if ro is None:
                    have_offs = False
                elif have_offs:
                    offs_parts.append(np.asarray(ro, np.int64))
            lens = (np.concatenate(lens_parts) if lens_parts
                    else np.zeros(0, np.int32))
            if have_offs:
                offs = (np.concatenate(offs_parts) if offs_parts
                        else np.zeros(0, np.int64))
                entry = (offs, lens)
                save_index(p, offs, lens)
            else:
                entry = None
            n_total += len(lens)
            if len(lens):
                maxlen = max(maxlen, int(lens.max()))
        else:
            n_total += len(entry[1])
            if len(entry[1]):
                maxlen = max(maxlen, int(entry[1].max()))
        index.append(entry)
    return n_total, maxlen, index
