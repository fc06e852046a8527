"""Canonical k-mer window hashing — the rkmh ``calc_hashes`` op.

Counterpart of ``rkmh_tpu/ops/hashing.py`` (``kmer_window_hashes`` :144,
``multi_k_window_hashes`` :183).  For every window start i of a
[B, L] uint8 code tensor (A=0 C=1 G=2 T=3, >= 4 invalid or padding):

* the hash is 0 if any code in [i, i+k) is >= 4;
* otherwise the canonical k-mer is the lexicographic min of the k-mer and
  its reverse complement (a tie goes to the forward strand), and its hash
  is the low 64 bits (h1) of MurmurHash3_x64_128, seed 42, over its ASCII
  bytes.

Results are [B, W] int64 holding the uint64 bit patterns, W = L-k+1;
multi-k concatenates the per-k blocks in k order.  On a CUDA tensor the
work goes to the window-hash kernel (``csrc/window_hash.cu``); on a CPU
tensor to the plain version below, which it must match bit for bit.
"""

from __future__ import annotations

import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.murmur3 import C1, C2, fmix64, rotl64

INVALID_HASH = 0


def _canonical_use_fwd(b: torch.Tensor, k: int, W: int) -> torch.Tensor:
    """Per-window bool: forward k-mer <= its reverse complement, decided
    outside-in at the first position where the two strands differ."""
    use_fwd = None  # fold from the LAST position backwards
    for p in range(k - 1, -1, -1):
        a = b[..., p : p + W]
        q = k - 1 - p
        r = 3 - b[..., q : q + W]  # rc base at window position p
        use_fwd = (a <= r) if use_fwd is None else torch.where(a == r, use_fwd, a < r)
    return use_fwd


def _pack_words(plane: torch.Tensor, starts, k: int, W: int):
    """ceil(k/8) little-endian words per window: byte p of the k-mer is
    plane[..., i + starts[p]]."""
    words = []
    for w in range((k + 7) // 8):
        acc = None
        for j in range(min(8, k - 8 * w)):
            off = starts[8 * w + j]
            lane = plane[..., off : off + W] << (8 * j)
            acc = lane if acc is None else acc | lane
        words.append(acc)
    return words


def _murmur3_h1_from_words(words, length: int, seed: int) -> torch.Tensor:
    """MurmurHash3_x64_128 h1 over pre-packed words (``hashing.py:72``)."""
    h1 = torch.full_like(words[0], seed)
    h2 = torch.full_like(words[0], seed)
    nblocks = length // 16
    for i in range(nblocks):
        k1 = rotl64(words[2 * i] * C1, 31) * C2
        h1 = h1 ^ k1
        h1 = rotl64(h1, 27) + h2
        h1 = h1 * 5 + 0x52DCEFB5
        k2 = rotl64(words[2 * i + 1] * C2, 33) * C1
        h2 = h2 ^ k2
        h2 = rotl64(h2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    tl = length - nblocks * 16
    if tl >= 9:
        h2 = h2 ^ (rotl64(words[2 * nblocks + 1] * C2, 33) * C1)
    if tl >= 1:
        h1 = h1 ^ (rotl64(words[2 * nblocks] * C1, 31) * C2)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return fmix64(h1) + fmix64(h2)


_ASCII = (65, 67, 71, 84)  # A C G T


def kmer_window_hashes_plain(codes: torch.Tensor, k: int, seed: int = 42) -> torch.Tensor:
    """Plain PyTorch window hashes: [..., L] uint8 -> [..., L-k+1] int64."""
    c = codes.to(torch.int64)
    W = c.shape[-1] - k + 1
    if W <= 0:
        return torch.zeros(c.shape[:-1] + (0,), dtype=torch.int64, device=c.device)
    bad = torch.cumsum((c >= 4).to(torch.int32), dim=-1)
    before = torch.cat([torch.zeros_like(bad[..., :1]), bad[..., : W - 1]], dim=-1)
    valid = (bad[..., k - 1 :] - before) == 0

    b = c & 3  # invalid windows are masked below, their bytes do not matter
    use_fwd = _canonical_use_fwd(b, k, W)
    ascii_lut = torch.tensor(_ASCII, dtype=torch.int64, device=c.device)
    fwd_words = _pack_words(ascii_lut[b], list(range(k)), k, W)
    rc_words = _pack_words(ascii_lut[3 - b], [k - 1 - p for p in range(k)], k, W)
    words = [torch.where(use_fwd, f, r) for f, r in zip(fwd_words, rc_words)]
    h1 = _murmur3_h1_from_words(words, k, seed)
    return torch.where(valid, h1, torch.zeros_like(h1))


def _window_hashes_cuda(codes: torch.Tensor, ks, seed: int) -> torch.Tensor:
    """K1 wrapper: one launch per k, each writing its column block of one
    [B, sum W] int64 output."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"window-hash kernel takes [B, L] uint8 codes, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    codes = codes.contiguous()
    B, L = codes.shape
    if (L + 127) // 128 > 65535 or 128 + max(ks) - 1 > 232448:
        raise ValueError(f"window-hash kernel: L={L} or k={max(ks)} past its "
                         "grid / shared-memory limits")
    widths = [max(L - k + 1, 0) for k in ks]
    out = torch.empty((B, sum(widths)), dtype=torch.int64, device=codes.device)
    col = 0
    for k, W in zip(ks, widths):
        if W and B:
            kernels.WINDOW_HASH(codes, B, L, k, seed, out, out.shape[1], col)
        col += W
    return out


def multi_k_window_hashes(codes: torch.Tensor, ks, seed: int = 42) -> torch.Tensor:
    """Per-k window hashes concatenated in k order (rkmh's repeated -k)."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    if any(k < 1 for k in ks):
        raise ValueError(f"k must be >= 1, got {ks}")
    if codes.device.type == "cuda":
        return _window_hashes_cuda(codes, ks, seed)
    if codes.device.type != "cpu":
        raise ValueError(f"no window-hash path for device {codes.device}")
    outs = [kmer_window_hashes_plain(codes, k, seed) for k in ks]
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]


def kmer_window_hashes(codes: torch.Tensor, k: int, seed: int = 42) -> torch.Tensor:
    """Canonical hash of every k-window: [B, L] uint8 -> [B, L-k+1] int64."""
    return multi_k_window_hashes(codes, [k], seed)


def window_mask(lengths: torch.Tensor, L: int, ks) -> torch.Tensor:
    """[B, sum_k (L-k+1)] bool, True for the windows that exist in the
    unpadded read, in the column order of multi_k_window_hashes
    (``rkmh_tpu/ops/hashing.py:213``)."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    parts = [torch.arange(L - k + 1, device=lengths.device)[None, :] < (lengths - (k - 1))[:, None]
             for k in ks if L - k + 1 > 0]
    if not parts:  # every k exceeds L: zero windows, like multi_k_window_hashes
        return torch.zeros(lengths.shape + (0,), dtype=torch.bool, device=lengths.device)
    return torch.cat(parts, dim=-1)
