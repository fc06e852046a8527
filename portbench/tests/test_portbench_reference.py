"""The plain reference: its hash against rkmh's, and its output against the
port's CPU path at a tiny size, with a corrupted output caught."""

import numpy as np
import pytest
import torch

from portbench import gen, run
from portbench.reference import kmers
from portbench.tests.conftest import TINY_READS, tiny

M = (1 << 64) - 1


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & M


def _fmix(k):
    for c in (0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53):
        k ^= k >> 33
        k = (k * c) & M
    return k ^ (k >> 33)


def murmur3_x64_128(data: bytes, seed: int) -> bytes:
    """Appleby's MurmurHash3_x64_128, one byte string at a time."""
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed
    n, nb = len(data), len(data) // 16
    for i in range(nb):
        k1 = int.from_bytes(data[16 * i: 16 * i + 8], "little")
        k2 = int.from_bytes(data[16 * i + 8: 16 * i + 16], "little")
        h1 ^= _rotl((k1 * c1) & M, 31) * c2 & M
        h1 = ((_rotl(h1, 27) + h2) * 5 + 0x52DCE729) & M
        h2 ^= _rotl((k2 * c2) & M, 33) * c1 & M
        h2 = ((_rotl(h2, 31) + h1) * 5 + 0x38495AB5) & M
    t = data[16 * nb:]
    if len(t) > 8:
        h2 ^= _rotl((int.from_bytes(t[8:], "little") * c2) & M, 33) * c1 & M
    if t:
        h1 ^= _rotl((int.from_bytes(t[:8], "little") * c1) & M, 31) * c2 & M
    h1, h2 = h1 ^ n, h2 ^ n
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    h1, h2 = _fmix(h1), _fmix(h2)
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    return h1.to_bytes(8, "little") + h2.to_bytes(8, "little")


def test_scalar_murmur3_is_appleby():
    """SMHasher's verification value of MurmurHash3_x64_128, 0x6384BA69."""
    out = bytearray()
    for i in range(256):
        out += murmur3_x64_128(bytes(range(i)), 256 - i)
    final = murmur3_x64_128(bytes(out), 0)
    assert int.from_bytes(final[:4], "little") == 0x6384BA69


def _canon_hash(kmer: bytes) -> int:
    if any(b not in b"ACGT" for b in kmer):
        return 0
    rc = kmer[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    h = int.from_bytes(murmur3_x64_128(min(kmer, rc), 42)[:8], "little")
    return h - (1 << 64) if h >> 63 else h


@pytest.mark.parametrize("k", [12, 16, 18, 21])
def test_window_hashes_match_scalar(k):
    rng = np.random.default_rng(k)
    seqs = [rng.choice(np.frombuffer(b"ACGTN", np.uint8), 60,
                       p=[0.24, 0.24, 0.24, 0.24, 0.04]).tobytes()
            for _ in range(5)]
    codes = kmers.codes_of(np.frombuffer(b"".join(seqs), dtype=np.uint8)).reshape(5, 60)
    got = kmers.window_hashes(torch.from_numpy(codes), k).numpy()
    want = [[_canon_hash(s[i: i + k]) for i in range(60 - k + 1)] for s in seqs]
    assert got.tolist() == want


def test_window_hashes_k12_match_port_oracle():
    """Below 16 bytes MurmurHash3 has no block: the port's hash is rkmh's."""
    from rkmh_tpu_torch import oracle

    s = b"ACGTTGCAACGGTACCATGNACGTAGCATCGA"
    codes = kmers.codes_of(np.frombuffer(s, dtype=np.uint8))[None]
    got = kmers.window_hashes(torch.from_numpy(codes), 12)[0].numpy().view(np.uint64)
    assert got.tolist() == [oracle.calc_hash(s[i: i + 12]) for i in range(len(s) - 11)]


@pytest.mark.parametrize("traffic", sorted(TINY_READS))
def test_reference_agrees_with_port_cpu(traffic, cache):
    cfg, tr = tiny(traffic)
    out = run.run_cell(cfg, tr, 2**31 + 77, 0.0, False, [], "cpu", 0.0)
    assert out["correct"], out
    assert out["checks"]["lines_wrong"]["value"] == 0 and out["attempted"] == 1


@pytest.mark.parametrize("traffic", sorted(TINY_READS))
def test_reference_catches_one_corrupted_line(traffic, cache):
    import importlib

    cfg, tr = tiny(traffic)
    inputs = gen.make_inputs(cfg, tr, 5, str(cache / "inputs"))
    ref = importlib.import_module(f"portbench.reference.{tr['command']}")
    text, nbytes = ref.expected(inputs, cfg, tr, "cpu")
    lines = text.splitlines(keepends=True)
    assert len(lines) > 10 and nbytes > 0
    i = len(lines) - 1
    lines[i] = lines[i].replace("\t", "\t1", 1)
    assert run.lines_wrong(text, "".join(lines)) == 1
    assert run.lines_wrong(text, "".join(lines[:-1])) == 1
