"""The port's native FASTA/FASTQ reader and line formatter
(``rkmh_tpu_torch/io/native``) against the JAX package's native reader and
the port's Python parser.

Inputs: synthetic files from ``rkmh_tpu_torch.synth`` (made from a seed)
and hand-written records: FASTQ with N bases, multi-line FASTA with
lowercase and IUPAC bases, an empty sequence, names with comments, CRLF
line ends, a plus-less FASTQ record, gzip, and several files of different
widths.  Chunks come off a reader thread (``common.read_ahead``): its order,
its errors, its shutdown when the consumer stops early, and a stress run
with more producers than cores and a shortened switch interval.  Every
output is integer, bytes or text and must be equal.
"""

import gzip
import io
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from rkmh_tpu.commands import common as jax_common
from rkmh_tpu.io import native as jax_native
from rkmh_tpu.commands.stream import format_lines_host as jax_format_lines_host
from rkmh_tpu_torch import synth
from rkmh_tpu_torch.commands import common, stream
from rkmh_tpu_torch.io import native
from rkmh_tpu_torch.io.fastx import iter_batches, read_fastx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HAND_FASTA = (">a desc here\nacgT\nACGN\n>b\tcomment\nRYKMSWBDHVN\nttttuU\n>empty\n\n"
              ">c\n" + "ACGTN" * 40 + "\n" + "gattaca" * 20 + "\n>last x\nA\n")
HAND_FASTQ = ("@q1 comment\nACGTNNGT\n+\nIIIIIIII\n@q2\r\nacgtac\r\n+q2\r\n!!##$$\r\n"
              "@q3\nNNNN\n+\nABCD\n@noplus\nACGT\n@q4\nGGCC\n+\nIIII\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    _, genomes = synth.make_panel(4, 2000, seed=3)
    fq = str(d / "reads.fq")
    synth.write_fastq(fq, synth.make_reads(genomes, 300, 150, n_rate=0.02, seed=4)[0])
    long_fq = str(d / "long.fq")
    synth.write_fastq(long_fq, synth.make_reads(genomes, 20, 700, seed=5)[0], first=300)
    refs = str(d / "refs.fa")
    synth.write_fasta(refs, [f"ref{i} genome {i}" for i in range(4)], synth._ACGTN[genomes])
    paths = {"fastq": fq, "long": long_fq, "refs": refs}
    for name, text in (("hand_fa", HAND_FASTA), ("hand_fq", HAND_FASTQ)):
        paths[name] = str(d / f"{name}.txt")
        with open(paths[name], "w", newline="") as fh:
            fh.write(text)
    for name in ("fastq", "refs", "hand_fa", "hand_fq"):
        paths[f"{name}_gz"] = paths[name] + ".gz"
        with open(paths[name], "rb") as src, gzip.open(paths[f"{name}_gz"], "wb") as dst:
            dst.write(src.read())
    return paths


INPUTS = ["fastq", "long", "refs", "hand_fa", "hand_fq", "fastq_gz", "refs_gz", "hand_fa_gz",
          "hand_fq_gz"]


def _same_records(got, want, exact_width=False):
    """Equal names, seqs, quals, lens and codes (padding beyond the shorter
    width all PAD_CODE)."""
    assert list(got.names) == list(want.names)
    assert list(got.seqs) == list(want.seqs)
    assert list(got.quals) == list(want.quals)
    assert np.array_equal(got.lens, want.lens) and got.lens.dtype == np.int32
    assert got.codes.dtype == np.uint8 and got.codes.shape[0] == len(got.lens)
    L = min(got.codes.shape[1], want.codes.shape[1])
    assert np.array_equal(got.codes[:, :L], want.codes[:, :L])
    assert (got.codes[:, L:] == 255).all() and (want.codes[:, L:] == 255).all()
    if exact_width:
        assert got.codes.shape == want.codes.shape


@pytest.mark.parametrize("name", INPUTS)
def test_native_reader_matches_jax_and_the_python_parser(files, name):
    path = files[name]
    got = common.load_packed([path])
    assert isinstance(got, native.PackedReads)
    _same_records(got, common.PyPacked(read_fastx(path)), exact_width=True)
    want = jax_common.load_packed([path])
    _same_records(got, want, exact_width=True)
    assert np.array_equal(got.rec_offs, want.rec_offs)
    # each record offset points at its header in the uncompressed text
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        raw = fh.read()
    assert all(raw[o:o + 1] in (b">", b"@") for o in got.rec_offs.tolist())


def test_hand_records_parse_as_rkmh_does(files):
    fa = native.read_fastx_packed(files["hand_fa"])
    assert fa.names == ["a", "b", "empty", "c", "last"]
    assert fa.seqs[:3] == [b"ACGTACGN", b"RYKMSWBDHVNTTTTUU", b""]
    assert fa.quals == [None] * 5
    assert fa.lens.tolist() == [8, 17, 0, 340, 1] and fa.codes.shape == (5, 384)
    assert fa.codes[0, :8].tolist() == [0, 1, 2, 3, 0, 1, 2, 4]
    assert (fa.codes[1, :11] == 4).all() and (fa.codes[2] == 255).all()
    fq = native.read_fastx_packed(files["hand_fq"])
    assert fq.names == ["q1", "q2", "q3", "noplus", "q4"]
    assert fq.seqs == [b"ACGTNNGT", b"ACGTAC", b"NNNN", b"ACGT", b"GGCC"]
    assert fq.quals == [b"IIIIIIII", b"!!##$$", b"ABCD", None, b"IIII"]


def test_an_empty_fastq_sequence_reads_as_the_jax_native_reader_reads_it(tmp_path):
    """The native parser skips blank lines after a header, so a FASTQ
    record with an empty sequence takes its '+' line as the sequence; the
    Python parser reads it empty.  rkmh-tpu parses paths natively, so the
    port does the same."""
    fq = tmp_path / "e.fq"
    fq.write_text("@empty\n\n+\n\n@q\nACGT\n+\nIIII\n")
    got, want = native.read_fastx_packed(str(fq)), jax_native.read_fastx_packed(str(fq))
    _same_records(got, want, exact_width=True)
    assert got.seqs[0] == b"+" and read_fastx(str(fq))[0].seq == b""


@pytest.mark.parametrize("chunk_reads", [1, 7, 65536])
@pytest.mark.parametrize("names", [["fastq"], ["hand_fa_gz", "hand_fq", "long"],
                                   ["refs_gz"]], ids=["fastq", "three-files", "gzip"])
def test_chunks_match_jax_and_the_python_parser(files, names, chunk_reads):
    paths = [files[n] for n in names]
    got = list(common.iter_packed_chunks(paths, chunk_reads))
    want = list(jax_common.iter_packed_chunks(paths, chunk_reads))
    python = [common.PyPacked(recs) for p in paths for recs in iter_batches(p, chunk_reads)]
    assert all(isinstance(c, native.PackedReads) for c in got)
    assert len(got) == len(want) == len(python)
    for g, w, p in zip(got, want, python):
        _same_records(g, w, exact_width=True)
        _same_records(g, p)
        assert np.array_equal(g.rec_offs, w.rec_offs)
        assert len(g) <= chunk_reads


@pytest.mark.parametrize("name", ["fastq", "hand_fq", "refs_gz"])
def test_stream_seek_to_a_record_offset(files, name):
    path = files[name]
    whole = native.read_fastx_packed(path)
    for at in (0, 1, len(whole) // 2, len(whole) - 1):
        with native.FastxStream(path) as s:
            assert s.next_chunk(2) is not None  # read past it first
            s.seek(int(whole.rec_offs[at]))
            rest = s.next_chunk(1 << 20)
            assert rest.names == whole.names[at:] and rest.seqs == whole.seqs[at:]
            assert np.array_equal(rest.rec_offs, whole.rec_offs[at:])
            assert s.next_chunk(1) is None
    with native.FastxStream(path) as s, pytest.raises(OSError, match="seek"):
        s.seek(-1)


def test_load_packed_concatenates_files_of_different_widths_as_jax(files):
    paths = [files["hand_fq"], files["long"], files["refs_gz"]]
    got = common.load_packed(paths)
    want = jax_common.load_packed(paths)
    _same_records(got, want, exact_width=True)
    assert got.codes.shape[1] == 2048  # the refs' 2,000 bp, padded to a multiple of 128
    assert len(got) == 5 + 20 + 4


def test_stdin_and_file_objects_keep_the_python_parser(files, monkeypatch):
    with open(files["hand_fq"], "rb") as fh:
        raw = fh.read()
    want = native.read_fastx_packed(files["hand_fq"])
    pk = common.load_packed(io.BytesIO(raw))
    assert isinstance(pk, common.PyPacked)
    _same_records(pk, want, exact_width=True)
    chunks = list(common.iter_packed_chunks([io.BytesIO(raw)], 4))
    assert [type(c) for c in chunks] == [common.PyPacked, common.PyPacked]
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(raw)))
    (chunk,) = common.iter_packed_chunks("-", 100)
    assert isinstance(chunk, common.PyPacked)
    _same_records(chunk, want, exact_width=True)


def test_a_missing_file_raises_what_the_python_parser_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        next(common.iter_packed_chunks([str(tmp_path / "none.fq")], 10))
    with pytest.raises(IsADirectoryError):
        common.load_packed([str(tmp_path)])


def test_malformed_input_raises(tmp_path):
    bad = tmp_path / "bad.fa"
    bad.write_text("no header\n")
    with pytest.raises(OSError, match="malformed"):
        native.read_fastx_packed(str(bad))
    with pytest.raises(OSError, match="malformed"):
        list(common.iter_packed_chunks([str(bad)], 10))


def test_a_broken_compiler_raises_and_nothing_falls_back(files, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="(?s)native io build failed .*no_such_header"):
        next(common.iter_packed_chunks([files["fastq"]], 10))
    with pytest.raises(RuntimeError, match="native io build failed"):
        common.load_packed([files["fastq"]])
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="native io build failed"):
        native.load()
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-compiler"))
    with pytest.raises(RuntimeError, match="native io build failed.*no-compiler"):
        native.load()
    assert native._lib is None and not list((tmp_path / "build").glob("*.so"))


def test_the_library_lands_in_the_port_build_dir(tmp_path, monkeypatch):
    jax_dir = os.path.join(REPO, "rkmh_tpu")

    def snapshot():  # file names only: the JAX package's own loader may rebuild its library
        return {os.path.join(d, f) for d, _, fs in os.walk(jax_dir) if "__pycache__" not in d
                for f in fs}

    path = native.library_path()
    assert path.parent == native.BUILD_DIR == Path(REPO, "rkmh_tpu_torch", "_build")
    assert path.name.startswith("librkmh_torch_io_") and path.suffix == ".so"
    before = snapshot()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    built = native.build()
    assert built.parent == tmp_path and built.exists()
    assert [p.name for p in tmp_path.iterdir()] == [built.name]  # no temporary left over
    assert snapshot() == before
    assert not [f for f in before if "librkmh_torch_io" in f]
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != built  # keyed by the flags


def test_threads_build_and_load_at_once(tmp_path, monkeypatch):
    """Threads that load the library first, and threads that build it
    into one path, at once: one library, loaded once, no temporary left."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    start = threading.Barrier(4)
    got, errors = [], []

    def loader():
        try:
            start.wait()
            got.append(native.load())
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    def builder():
        try:
            start.wait()
            native.build(tmp_path / "built.so")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (loader, loader, builder, builder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert len(got) == 2 and got[0] is got[1] is native._lib
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["built.so", native.library_path().name])


def _format_inputs(seed, n, n_names):
    rng = np.random.default_rng(seed)
    names = [f"read{i}" + ("_x" * (i % 3)) for i in range(n_names)]
    ref_keys = [f"ref{r} key" for r in range(7)]
    arr = np.stack([rng.integers(0, 7, n), rng.integers(0, 1000, n), rng.integers(0, 8, n)])
    return names, ref_keys, arr


@pytest.mark.parametrize("sketch_size", [1000, 50])
def test_block_formatter_matches_the_line_formatters(sketch_size):
    names, ref_keys, arr = _format_inputs(sketch_size, 40, 100)
    rows = np.arange(30, 70)
    blob = "".join(names).encode()
    offs = np.cumsum([0] + [len(n) for n in names])
    fmt = stream._NativeFormatCtx(ref_keys, sketch_size)
    chunk = common.NamesOnly(type("Chunk", (), {"_names_blob": blob, "_name_offs": offs})())
    got = fmt.format_block(arr, rows, chunk)
    picked = [names[i] for i in rows]
    assert got == "".join(stream.format_lines_host(ref_keys, picked, arr, sketch_size))
    assert got == jax_format_lines_host(ref_keys, picked, arr, sketch_size)
    assert got.encode() == jax_native.format_lines_block(
        arr, rows, blob, offs, fmt.ref_blob, fmt.ref_offs, fmt.tails_blob, fmt.tail_offs)
    assert chunk.names == names
    with pytest.raises(ValueError, match="row id"):
        fmt.format_block(arr, rows + 61, chunk)


def test_chunk_state_renders_input_order_from_mixed_parts():
    names, ref_keys, arr = _format_inputs(1, 12, 12)
    lines = stream.format_lines_host(ref_keys, names, arr, 1000)
    st = common.LinesChunk(common.PyPacked([]))
    st.n = 12
    st.parts = [(6, "".join(lines[6:12])), ([1, 3, 5], [lines[i] for i in (1, 3, 5)]),
                (0, lines[0]), ([2, 4], [lines[2], lines[4]])]
    assert st.render() == "".join(lines)
    st.parts = [(4, "".join(lines[4:])), (0, "".join(lines[:4]))]
    assert st.render() == "".join(lines)


def _read_ahead_threads():
    return {t for t in threading.enumerate() if t.name == "rkmh-read-ahead"}


def test_read_ahead_keeps_order_and_raises_after_the_items_before_the_error():
    def items():
        yield from range(5)
        raise ValueError("bad record")

    before = _read_ahead_threads()
    got = []
    with pytest.raises(ValueError, match="bad record"):
        for x in common.read_ahead(items(), depth=2):
            got.append(x)
    assert got == list(range(5))
    assert _read_ahead_threads() <= before


def test_read_ahead_closed_early_stops_its_thread_and_closes_the_items():
    closed = threading.Event()

    def items():
        try:
            yield from range(1000)
        finally:
            closed.set()

    before = _read_ahead_threads()
    gen = common.read_ahead(items())
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    assert closed.wait(timeout=10) and _read_ahead_threads() <= before


def test_read_ahead_under_frequent_thread_switches():
    """Many producers at once, more than the cores, switching every few
    microseconds: every item arrives once and in order."""
    before = _read_ahead_threads()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = [None] * 16

        def consume(k):
            results[k] = list(common.read_ahead(iter(range(k, k + 2000)), depth=1 + k % 3))

        workers = [threading.Thread(target=consume, args=(k,)) for k in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert results == [list(range(k, k + 2000)) for k in range(16)]
    assert _read_ahead_threads() <= before


def test_native_chunks_are_parsed_on_the_reader_thread(files, monkeypatch):
    parsers = set()
    real = native.FastxStream.next_chunk

    def next_chunk(self, *args):
        parsers.add(threading.current_thread().name)
        return real(self, *args)

    monkeypatch.setattr(native.FastxStream, "next_chunk", next_chunk)
    chunks = list(common.iter_packed_chunks([files["fastq"], files["long"]], 64))
    assert sum(len(c) for c in chunks) == 320 and parsers == {"rkmh-read-ahead"}
