"""The port's input-index cache (``rkmh_tpu_torch/io/input_index.py``) and
the rank batches it seeks to (``commands/dist_stream._iter_owned_batches``).

The cases of ``tests/test_input_index.py``, run on the port's copy: the
index is invisible in the output (the seek path yields what the full
reparse yields, for every rank of several geometries), it is never
written next to the input, a changed input (a same-size, timestamp-keeping
swap too) invalidates its entry, the GC drops dead entries past the cap,
gzip stays unindexed and ``RKMH_TPU_INPUT_INDEX=0`` turns it off.  Then
across packages: an entry either package writes loads in the other, and
the port's rank batches equal rkmh-tpu's.  Tolerance: none.
"""

import gzip
import os
import random

import numpy as np
import pytest

from rkmh_tpu.commands.dist_stream import _iter_owned_batches as jax_iter_owned_batches
from rkmh_tpu.io import input_index as jax_input_index
from rkmh_tpu_torch.commands.dist_stream import _iter_owned_batches
from rkmh_tpu_torch.io import input_index
from rkmh_tpu_torch.io.packing import bucket_length


def _write_fastq(path, n, seed=0, minlen=5, maxlen=300):
    rng = random.Random(seed)
    recs = []
    with open(path, "w") as fh:
        for i in range(n):
            seq = "".join(rng.choice("ACGTN") for _ in range(rng.randrange(minlen, maxlen)))
            fh.write(f"@r{seed}_{i} extra meta\n{seq}\n+\n{'I' * len(seq)}\n")
            recs.append(seq)
    return recs


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("RKMH_TPU_INPUT_INDEX", str(tmp_path / "idxcache"))


def test_scan_or_index_counts_offsets_and_caches(tmp_path, monkeypatch):
    p = str(tmp_path / "reads.fq")
    seqs = _write_fastq(p, 23, seed=1)
    n, maxlen, index = input_index.scan_or_index([p], chunk_reads=5)
    assert n == 23 and maxlen == max(len(s) for s in seqs)
    (entry,) = index
    offs, lens = entry
    assert list(lens) == [len(s) for s in seqs]
    raw = open(p, "rb").read()
    assert all(raw[o:o + 1] == b"@" for o in offs)
    assert os.path.exists(input_index.index_path(p))
    assert sorted(os.listdir(tmp_path)) == ["idxcache", "reads.fq"]

    import rkmh_tpu_torch.commands.common as common

    def boom(*a, **k):
        raise AssertionError("reparsed despite a fresh index entry")

    monkeypatch.setattr(common, "iter_packed_chunks", boom)
    n2, maxlen2, index2 = input_index.scan_or_index([p], chunk_reads=5)
    assert (n2, maxlen2) == (n, maxlen)
    np.testing.assert_array_equal(index2[0][0], offs)
    np.testing.assert_array_equal(index2[0][1], lens)


def test_stale_entry_is_rebuilt(tmp_path):
    p = str(tmp_path / "reads.fq")
    _write_fastq(p, 7, seed=2)
    input_index.scan_or_index([p], chunk_reads=64)
    assert input_index.load_index(p) is not None
    _write_fastq(p, 9, seed=3)
    assert input_index.load_index(p) is None
    n, _, index = input_index.scan_or_index([p], chunk_reads=64)
    assert n == 9 and len(index[0][1]) == 9


def test_same_size_mtime_preserving_swap_invalidates(tmp_path):
    p = str(tmp_path / "reads.fq")
    _write_fastq(p, 7, seed=20)
    input_index.scan_or_index([p], chunk_reads=64)
    st = os.stat(p)
    data = bytearray(open(p, "rb").read())
    at = data.index(b"\n") + 1
    data[at] = ord("A") if data[at] != ord("A") else ord("C")
    with open(p, "wb") as fh:
        fh.write(bytes(data))
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert (os.stat(p).st_size, os.stat(p).st_mtime_ns) == (st.st_size, st.st_mtime_ns)
    assert input_index.load_index(p) is None


def test_gc_drops_dead_entries_past_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("RKMH_TPU_INPUT_INDEX_MAX", "3")
    keep = []
    for i in range(2):
        p = str(tmp_path / f"live{i}.fq")
        _write_fastq(p, 3, seed=30 + i)
        input_index.scan_or_index([p], chunk_reads=64)
        keep.append(p)
    dead = str(tmp_path / "dead.fq")
    _write_fastq(dead, 3, seed=40)
    input_index.scan_or_index([dead], chunk_reads=64)
    dead_idx = input_index.index_path(dead)
    assert os.path.exists(dead_idx)
    os.remove(dead)
    p = str(tmp_path / "trigger.fq")
    _write_fastq(p, 3, seed=41)
    input_index.scan_or_index([p], chunk_reads=64)
    assert not os.path.exists(dead_idx)
    for kp in keep + [p]:
        assert input_index.load_index(kp) is not None


def test_gzip_inputs_fall_back_unindexed(tmp_path):
    p = str(tmp_path / "reads.fq")
    _write_fastq(p, 11, seed=4)
    gz = str(tmp_path / "reads.fq.gz")
    with open(p, "rb") as fi, gzip.open(gz, "wb") as fo:
        fo.write(fi.read())
    assert not input_index.is_indexable(gz)
    n, maxlen, index = input_index.scan_or_index([gz], chunk_reads=4)
    assert n == 11 and index == [None]


def test_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("RKMH_TPU_INPUT_INDEX", "0")
    p = str(tmp_path / "reads.fq")
    _write_fastq(p, 5, seed=5)
    n, _, index = input_index.scan_or_index([p], chunk_reads=64)
    assert n == 5 and index == [None]


def _same_batches(got, want, with_records=False):
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        assert gt[0] == wt[0]
        np.testing.assert_array_equal(gt[1], wt[1])
        np.testing.assert_array_equal(gt[2], wt[2])
        assert list(gt[3]) == list(wt[3])
        if with_records:
            assert list(gt[4]) == list(wt[4])


@pytest.mark.parametrize("with_records", [False, True])
def test_indexed_iter_bit_identical_to_reparse_and_to_jax(tmp_path, with_records):
    """Two files, every rank of H = 1, 2, 3, trailing pad batches, small
    chunks: the seek path, the reparse and rkmh-tpu's iterator agree."""
    p1, p2 = str(tmp_path / "a.fq"), str(tmp_path / "b.fq")
    _write_fastq(p1, 17, seed=6)
    _write_fastq(p2, 8, seed=7)
    files = [p1, p2]
    N, maxlen, index = input_index.scan_or_index(files, chunk_reads=6)
    assert N == 25 and all(e is not None for e in index)
    L = bucket_length(maxlen)
    for H in (1, 2, 3):
        B = 6 * H
        for rank in range(H):
            args = (files, 6, N, B, B // H, rank, L)
            ref = list(_iter_owned_batches(*args, with_records=with_records))
            got = list(_iter_owned_batches(*args, with_records=with_records, index=index))
            assert len(got) == -(-N // B)
            _same_batches(got, ref, with_records)
            _same_batches(got, list(jax_iter_owned_batches(
                *args, with_records=with_records, index=index)), with_records)


def test_indexed_iter_start_batch_skips_exactly(tmp_path):
    p = str(tmp_path / "a.fq")
    _write_fastq(p, 29, seed=8)
    N, maxlen, index = input_index.scan_or_index([p], chunk_reads=64)
    L = bucket_length(maxlen)
    full = list(_iter_owned_batches([p], 64, N, 8, 4, 1, L, index=index))
    tail = list(_iter_owned_batches([p], 64, N, 8, 4, 1, L, index=index, start_batch=2))
    _same_batches(tail, full[2:])
    _same_batches(list(_iter_owned_batches([p], 64, N, 8, 4, 1, L, start_batch=2)), tail)


def test_indexed_iter_detects_changed_input(tmp_path):
    p = str(tmp_path / "a.fq")
    _write_fastq(p, 12, seed=9)
    N, maxlen, index = input_index.scan_or_index([p], chunk_reads=64)
    L = bucket_length(maxlen)
    with open(p, "w") as fh:
        fh.write("@only\nACGT\n+\nIIII\n")
    with pytest.raises(RuntimeError, match="changed under its input index"):
        list(_iter_owned_batches([p], 64, N, 4, 4, 0, L, index=index))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_entries_load_in_both_packages(tmp_path, writer):
    """Same key, fields, version and fingerprint: an entry either package
    writes is a fresh entry for the other, and both read equal offsets."""
    p = str(tmp_path / "reads.fq")
    _write_fastq(p, 31, seed=10)
    first, other = ((input_index, jax_input_index) if writer == "port"
                    else (jax_input_index, input_index))
    assert input_index.index_path(p) == jax_input_index.index_path(p)
    n, maxlen, index = first.scan_or_index([p], chunk_reads=7)
    assert os.path.exists(first.index_path(p))
    entry = other.load_index(p)
    assert entry is not None
    np.testing.assert_array_equal(entry[0], index[0][0])
    np.testing.assert_array_equal(entry[1], index[0][1])
    with np.load(first.index_path(p)) as z:
        assert sorted(z.files) == ["content", "lens", "mtime_ns", "offs", "size", "src",
                                   "version"]
        assert int(z["version"]) == input_index._VERSION == jax_input_index._VERSION
    assert other.scan_or_index([p], chunk_reads=7)[:2] == (n, maxlen)
