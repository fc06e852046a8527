"""Canonical k-mer hashes in plain PyTorch, and a plain FASTA/FASTQ reader.

rkmh's hash of a k-mer (rkmh.cpp:494-497, mkmh's calc_hashes): the k-mer
is invalid, hash 0, if it holds a base other than ACGT; otherwise the hash
is the low 64 bits of MurmurHash3_x64_128 (Austin Appleby's, seed 42) of
the ASCII bytes of the lexicographically smaller of the k-mer and its
reverse complement.  Hashes are held as int64 bit patterns: products,
sums, XOR and left shifts wrap as uint64 arithmetic does; right shifts are
masked to logical ones.

Two switches break the hash's guarantees, for the benchmark's controls:
``hash_bits`` < 64 keeps only the low bits of every hash, and
``canonical=False`` hashes the k-mer as read, not the smaller strand.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 42
PAD = 4  # a base code that no valid k-mer holds: N, anything else, padding


def _i64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


C1, C2 = _i64(0x87C37B91114253D5), _i64(0x4CF5AD432745937F)
F1, F2 = _i64(0xFF51AFD7ED558CCD), _i64(0xC4CEB9FE1A85EC53)
N1, N2 = 0x52DCE729, 0x38495AB5


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix(k: torch.Tensor) -> torch.Tensor:
    k = (k ^ _shr(k, 33)) * F1
    k = (k ^ _shr(k, 33)) * F2
    return k ^ _shr(k, 33)


def murmur3_h1(words: list, length: int, seed: int = SEED) -> torch.Tensor:
    """h1 of MurmurHash3_x64_128 of ``length`` bytes given as little-endian
    64-bit words (``words[j]`` holds bytes 8j..8j+7, zero past the end)."""
    h1 = torch.full_like(words[0], seed)
    h2 = torch.full_like(words[0], seed)
    nb = length // 16
    for b in range(nb):
        h1 = h1 ^ (_rotl(words[2 * b] * C1, 31) * C2)
        h1 = (_rotl(h1, 27) + h2) * 5 + N1
        h2 = h2 ^ (_rotl(words[2 * b + 1] * C2, 33) * C1)
        h2 = (_rotl(h2, 31) + h1) * 5 + N2
    tail = length - 16 * nb
    if tail > 8:
        h2 = h2 ^ (_rotl(words[2 * nb + 1] * C2, 33) * C1)
    if tail > 0:
        h1 = h1 ^ (_rotl(words[2 * nb] * C1, 31) * C2)
    h1, h2 = h1 ^ length, h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix(h1) + _fmix(h2)


_CODE = np.full(256, PAD, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _CODE[_c + 32] = _i


def codes_of(ascii_bytes: np.ndarray) -> np.ndarray:
    """ASCII bases (either case) -> codes A0 C1 G2 T3, PAD for the rest."""
    return _CODE[ascii_bytes]


def window_hashes(codes: torch.Tensor, k: int, hash_bits: int = 64,
                  canonical: bool = True) -> torch.Tensor:
    """[B, L] codes (PAD past a read's end) -> [B, L - k + 1] int64 hashes
    of every window, 0 where a window is invalid."""
    B, L = codes.shape
    W = L - k + 1
    c = codes.to(torch.int64)
    bad = torch.cat([c.new_zeros(B, 1), (c > 3).to(torch.int64).cumsum(1)], 1)
    invalid = (bad[:, k:] - bad[:, :W]) > 0
    c = c & 3
    fwd = torch.zeros(B, W, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for i in range(k):
        ci = c[:, i: i + W]
        fwd = (fwd << 2) | ci
        rc = rc | ((3 - ci) << (2 * i))
    # the 2-bit order is the ASCII order; both are below 2**62
    canon = torch.minimum(fwd, rc) if canonical else fwd
    ascii_ = torch.tensor(list(b"ACGT"), dtype=torch.int64, device=codes.device)
    words = []
    for w in range((k + 7) // 8):
        acc = torch.zeros_like(canon)
        for j in range(min(8, k - 8 * w)):
            p = 8 * w + j
            acc = acc | (ascii_[_shr(canon, 2 * (k - 1 - p)) & 3] << (8 * j))
        words.append(acc)
    h = murmur3_h1(words, k)
    if hash_bits < 64:
        h = h & ((1 << hash_bits) - 1)
    return torch.where(invalid, torch.zeros_like(h), h)


def hash_rows(codes: np.ndarray, lens: np.ndarray, k: int, device, **hash_kw):
    """Hash [N, L] padded code rows in blocks on ``device``; yields (row
    offset, [n, W] int64 hashes, [n, W] bool window-exists mask)."""
    N, L = codes.shape
    W = L - k + 1
    step = max(1, (1 << 23) // max(W, 1))  # ~8M windows a block
    for r0 in range(0, N, step):
        c = torch.from_numpy(codes[r0: r0 + step]).to(device)
        n = torch.from_numpy(lens[r0: r0 + step].astype(np.int64)).to(device)
        h = window_hashes(c, k, **hash_kw)
        exists = torch.arange(W, device=device)[None, :] < (n[:, None] - k + 1)
        yield r0, h, exists


def read_fastx(path: str):
    """-> (names: the header up to its first whitespace, [N, Lmax] uint8
    codes padded with PAD, [N] lengths).  FASTA records may span lines;
    FASTQ records are four lines."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:1] == b"@":
        lines = data.split(b"\n")
        heads, seqs = lines[0::4][: len(lines) // 4], lines[1::4][: len(lines) // 4]
    else:
        heads, seqs = [], []
        for rec in data.split(b">")[1:]:
            head, _, body = rec.partition(b"\n")
            heads.append(b"@" + head)
            seqs.append(body.replace(b"\n", b""))
    names = [h[1:].split(None, 1)[0].decode() if h[1:].split() else "" for h in heads]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    codes = np.full((len(seqs), int(lens.max(initial=0))), PAD, dtype=np.uint8)
    if len(set(lens.tolist())) == 1 and len(seqs):
        codes[:] = codes_of(np.frombuffer(b"".join(seqs), dtype=np.uint8)).reshape(codes.shape)
    else:
        for i, s in enumerate(seqs):
            codes[i, : len(s)] = codes_of(np.frombuffer(s, dtype=np.uint8))
    return names, codes, lens
