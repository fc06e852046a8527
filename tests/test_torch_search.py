"""`rkmh-tpu-torch search` output byte-identical to `rkmh-tpu search`.

Both packages search the same synthetic reads (rkmh_tpu_torch.synth, made
from a seed: 150 bp FASTQ reads with N bases, and a FASTA file of mixed
lengths, empty and shorter than k included) against reference token files
holding distinct 12-mers drawn from the genomes, lowercase tokens, tokens
of another length than k (hashed at their own length, as rkmh does),
tokens with N (hash 0: never a member), blank and whitespace-only lines;
and against an empty file.  Also: the host hash of the tokens, and the
device membership step (``member_mask``: searchsorted on sign-flipped
int64) against numpy's unsigned ``isin``.  The port runs its plain path on
the CPU.  Tolerance: none; outputs must be equal.
"""

import io

import numpy as np
import pytest
import torch

from rkmh_tpu.cli import main as jax_main
from rkmh_tpu.commands import search_cmd as jcmd
from rkmh_tpu_torch import cli, synth
from rkmh_tpu_torch.commands import search_cmd


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("search")
    _, short, _, _ = synth.write_workload(str(d / "short"), 80, 150, num_refs=4,
                                          genome_len=1500, seed=8, n_rate=0.02)
    names, genomes = synth.make_panel(4, 1500, seed=8)
    reads, _ = synth.make_reads(genomes, 30, 300, seed=9)
    lens = np.random.default_rng(10).integers(0, 300, 30)
    lens[:4] = (0, 5, 11, 12)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as fh:
        for i, (r, n) in enumerate(zip(reads, lens)):
            fh.write(f">s{i}\n{r[:n].tobytes().decode()}\n")
    rng = np.random.default_rng(11)
    ascii_g = synth._ACGTN[genomes]
    starts = rng.integers(0, 1500 - 16, 200)
    rows = rng.integers(0, 4, 200)
    mers = sorted({ascii_g[r, p: p + 12].tobytes().decode() for r, p in zip(rows, starts)})
    kmers = str(d / "kmers.txt")
    with open(kmers, "w") as fh:
        for m in mers:
            fh.write(f"{m}\tcount 3\n")
        fh.write(f"{mers[0].lower()}\n\n   \n{mers[1][:11]}\n{mers[2] + 'A'}\n"
                 f"{mers[3][:5]}N{mers[3][6:]}\n{ascii_g[0, 100:116].tobytes().decode()}\n")
    empty = str(d / "empty.txt")
    open(empty, "w").close()
    return {"short": short, "mixed": mixed, "kmers": kmers, "empty": empty}


def _both(workload, capsys, refs, reads, **kw):
    files = [workload[r] for r in reads]
    outs = []
    for mod, extra in ((jcmd, {}), (search_cmd, {"device": "cpu"})):
        capsys.readouterr()
        buf = io.StringIO()
        assert mod.run(mod.SearchConfig(ref_files=[workload[refs]], read_files=files, **kw,
                                        **extra), out=buf) == 0
        err = [ln for ln in capsys.readouterr().err.splitlines() if "cpu_aot_loader" not in ln]
        outs.append((buf.getvalue(), err))
    return outs


@pytest.mark.parametrize("refs,reads,kw", [
    ("kmers", ["short"], dict(ks=(12,))),
    ("kmers", ["mixed", "short"], dict(ks=(12,), batch_size=8, chunk_reads=11)),
    ("kmers", ["short"], dict(ks=(12, 16))),
    ("kmers", ["mixed"], dict(ks=(16,))),
    ("kmers", ["short"], dict()),
    ("empty", ["mixed"], dict(ks=(12,))),
], ids=["k12", "mixed-chunks", "multi-k", "k16", "default-k", "empty-refs"])
def test_search_output_byte_identical_to_jax(workload, capsys, refs, reads, kw):
    (want, want_err), (got, got_err) = _both(workload, capsys, refs, reads, **kw)
    assert got == want and got_err == want_err
    if refs == "kmers" and kw.get("ks", (16,))[0] == 12:
        assert "," in want  # some reads hold several reference k-mers
    if "mixed" in reads:  # no line for a read shorter than k
        k = kw["ks"][0]
        names = {ln.split("\t")[0] for ln in want.splitlines()}
        assert {"s0", "s1", "s2"}.isdisjoint(names) and ("s3" in names) == (k <= 12)


def test_cli_search_matches_jax(workload, capsys, tmp_path):
    argv = ["search", "-r", workload["kmers"], "-f", workload["mixed"], "-k", "12"]
    assert jax_main([*argv, "-o", str(tmp_path / "jax.txt")]) == 0
    assert cli.main([*argv, "--device", "cpu", "-o", str(tmp_path / "torch.txt")]) == 0
    assert (tmp_path / "torch.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_reference_tokens_hash_as_jax(workload):
    want = jcmd.load_ref_kmers([workload["kmers"]])
    got = search_cmd.load_ref_kmers([workload["kmers"]])
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert (got >= np.uint64(2**63)).any() and np.all(np.diff(got) > 0)
    assert search_cmd.load_ref_kmers([workload["empty"]]).size == 0


def test_member_mask_matches_unsigned_isin():
    rng = np.random.default_rng(3)
    ref = np.unique(rng.integers(0, 2**64 - 1, 500, dtype=np.uint64))
    ref[0] = np.uint64(2**63)  # INT64_MIN's bits: the lowest signed key is the middle value
    ref = np.unique(np.concatenate([ref, [np.uint64(2**64 - 1)]]))
    hashes = rng.choice(np.concatenate([ref, rng.integers(0, 2**64 - 1, 500,
                                                          dtype=np.uint64)]), size=(30, 40))
    hashes[:, ::7] = 0
    hashes[0, :3] = (np.uint64(2**64 - 1), np.uint64(2**63), np.uint64(1))
    got = search_cmd.member_mask(torch.from_numpy(hashes.view(np.int64)),
                                 search_cmd.sorted_keys(ref, "cpu"))
    want = np.isin(hashes, ref) & (hashes != 0)
    assert np.array_equal(got.numpy(), want) and want.any() and not want.all()
    none = search_cmd.member_mask(torch.from_numpy(hashes.view(np.int64)),
                                  search_cmd.sorted_keys(np.zeros(0, np.uint64), "cpu"))
    assert none.shape == hashes.shape and not none.any()


def test_search_resume_needs_an_out_file(capsys):
    assert search_cmd.run(search_cmd.SearchConfig(ref_files=["k.txt"], read_files=["x.fq"],
                                                  resume=True, device="cpu")) == 1
    assert "search --resume requires -o/--out" in capsys.readouterr().err


def test_search_line_formatter_matches_a_line_by_line_join():
    """``format_search_lines`` (one gather of a batch's k-mers) against the JAX
    package's per-read join (search_cmd.py:122-129), on rows out of order,
    reads shorter than k, reads with no hit and a hit at the last window."""
    rng = np.random.default_rng(4)
    k = 5
    seqs = [rng.choice(list(b"ACGTN"), n).astype(np.uint8).tobytes()
            for n in (0, 3, 4, 5, 9, 30, 17, 12)]
    names = [f"n{i}" * (i % 3 + 1) for i in range(len(seqs))]
    rows = np.array([5, 0, 7, 2, 4, 1, 6, 3])
    lens = np.array([len(seqs[r]) for r in rows])
    found = rng.random((len(rows), 26)) < 0.4
    found[rows.tolist().index(4)] = False  # 9 bases, no hit
    found[rows.tolist().index(5), 25] = True  # the last window of the 30-base read

    def blob(items):
        offs = np.cumsum([0] + [len(x) for x in items]).astype(np.int64)
        return b"".join(items), offs

    got = search_cmd.format_search_lines(found, lens, k, rows, blob([n.encode() for n in names]),
                                         blob(seqs))
    assert len(got) == len(rows)
    for i, r in enumerate(rows):
        nwin = len(seqs[r]) - k + 1
        want = b"" if nwin <= 0 else (names[r] + "\t" + ",".join(
            seqs[r][p: p + k].decode() for p in np.nonzero(found[i, :nwin])[0]) + "\n").encode()
        assert got[i] == want
    assert b"".join(got).count(b"\n") == 5
