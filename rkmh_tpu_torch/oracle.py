"""Host canonical hash of one k-mer token.

A copy of ``rkmh_tpu/oracle.py:31-47`` (``revcomp``, ``calc_hash``), the
part the port needs: ``search`` hashes each reference token on the host at
its own length, whatever k is.  The token is uppercased; any base other
than ACGT makes it invalid (hash 0); otherwise the hash is the low 64 bits
of MurmurHash3_x64_128, seed 42, of the lexicographic min of the token and
its reverse complement.
"""

from __future__ import annotations

from rkmh_tpu_torch.ops.murmur3 import murmur3_x64_128_np

_COMP = {65: 84, 67: 71, 71: 67, 84: 65}  # A<->T, C<->G (ASCII)
_ACGT = frozenset(b"ACGT")


def revcomp(seq: bytes) -> bytes:
    return bytes(_COMP[b] for b in reversed(seq))


def calc_hash(kmer: bytes | str, seed: int = 42) -> int:
    """Canonical hash of one k-mer; 0 if it holds a base other than ACGT."""
    if isinstance(kmer, str):
        kmer = kmer.encode()
    kmer = kmer.upper()
    if any(b not in _ACGT for b in kmer):
        return 0
    rc = revcomp(kmer)
    return murmur3_x64_128_np(kmer if kmer <= rc else rc, seed)[0]
