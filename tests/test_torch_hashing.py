"""rkmh_tpu_torch window hashing vs the JAX package, bit for bit.

Inputs are made from a seed with numpy and fed to both packages.  The
plain PyTorch path runs on the CPU (the CUDA kernel's tests are in
test_torch_kernels.py).  Tolerance: none (integer hashes must be equal).
"""

import numpy as np
import pytest
import torch

from rkmh_tpu import oracle
from rkmh_tpu.ops import murmur3 as jmurmur
from rkmh_tpu.ops.hashing import kmer_window_hashes as jax_hashes
from rkmh_tpu.ops.hashing import multi_k_window_hashes as jax_multi_k
from rkmh_tpu.ops.pallas_hash import kmer_window_hashes_pallas
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops import murmur3
from rkmh_tpu_torch.ops.hashing import (
    kmer_window_hashes,
    kmer_window_hashes_plain,
    multi_k_window_hashes,
)

KS = [4, 8, 9, 12, 16, 17, 31, 32, 33]


def _codes(seed, shape=(16, 96)):
    """Random codes with invalid ones (4, 5) mixed in."""
    return np.random.default_rng(seed).integers(0, 6, size=shape).astype(np.uint8)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("k", KS)
def test_plain_matches_jax(k):
    codes = _codes(k)
    want = np.asarray(jax_hashes(codes, k))
    got = _u64(kmer_window_hashes(torch.from_numpy(codes), k))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [4, 12, 16, 17, 31, 32])
def test_plain_matches_pallas_interpret(k):
    codes = _codes(100 + k)
    want = np.asarray(kmer_window_hashes_pallas(codes, k, interpret=True))
    got = _u64(kmer_window_hashes_plain(torch.from_numpy(codes), k))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [9, 12, 16, 33])
def test_plain_matches_oracle(k):
    rng = np.random.default_rng(k)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [acgt[rng.integers(0, 4, n)].tobytes() for n in (40, 57, 64)]
    seqs[1] = seqs[1][:20] + b"N" + seqs[1][21:]  # an invalid base
    codes, lens = encode_seqs(seqs, pad_to=64)
    got = _u64(kmer_window_hashes(torch.from_numpy(codes), k))
    for i, s in enumerate(seqs):
        want = oracle.calc_hashes(s, k)
        assert got[i, : len(want)].tolist() == want
        assert not got[i, len(want):].any()  # padding windows hash to 0


def test_multi_k_concatenates_in_k_order():
    codes = _codes(5, (8, 80))
    want = np.asarray(jax_multi_k(codes, [12, 16, 33]))
    got = _u64(multi_k_window_hashes(torch.from_numpy(codes), [12, 16, 33]))
    assert np.array_equal(got, want)


def test_rows_shorter_than_k_have_no_windows():
    got = kmer_window_hashes(torch.zeros((3, 10), dtype=torch.uint8), 12)
    assert got.shape == (3, 0)


def test_murmur_primitives_match_golden():
    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(0, 2**64, size=64, dtype=np.uint64)]
    x = torch.tensor([murmur3.as_i64(v) for v in vals], dtype=torch.int64)
    got_f = _u64(murmur3.fmix64(x)).tolist()
    assert got_f == [jmurmur._fmix64(v) for v in vals]
    for r in (1, 27, 31, 33, 63):
        got_r = _u64(murmur3.rotl64(x, r)).tolist()
        assert got_r == [jmurmur._rotl64(v, r) for v in vals]


def test_unsupported_device_raises():
    codes = torch.zeros((2, 20), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        multi_k_window_hashes(codes, [4])
