"""rkmh_tpu_torch's exact hash map (call's depth map) against the JAX package.

Keys are made from a seed with numpy and fed to both packages: the port's
numpy cuckoo build must give the JAX build's arrays, and the port's table
(``convert.hashmap_from_numpy`` of the JAX map), read by the plain lookup
on the CPU, must give the JAX ``hashmap_get``'s values on every key, key
0, keys at or above 2**63, keys whose lo or hi half is at or above 2**31,
and misses.  Tolerance: none (integers).  Also: the kernel library's name
follows every source and header (a changed header builds anew), without
nvcc.  K8 itself is held against the plain lookup on the card in
test_torch_kernels.py.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rkmh_tpu.ops import hashmap as jhashmap
from rkmh_tpu_torch import convert
from rkmh_tpu_torch.ops import hashmap, kernels

FIELDS = ("hash_hi", "hash_lo", "used", "values")


def _keys(seed: int, n: int) -> np.ndarray:
    """n distinct uint64 keys: 0, keys >= 2**63, keys whose lo or hi half
    is >= 2**31 or < 2**31, and random ones.  No three of them agree in
    the low 31 bits of both halves: the two slots of such keys coincide
    at every table size up to 2**31, and the cuckoo build of either
    package doubles its table without end (ROADMAP C)."""
    rng = np.random.default_rng(seed)
    special = np.array([0, 1, 2**64 - 1, 0x80000000_00000005, 0x00000003_80000007,
                        0x9ABCDEF0_12345678, 0x7FFFFFFF_FFFFFFFE, 0xFFFFFFFF_00000002],
                       dtype=np.uint64)
    rand = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64, endpoint=True)
    return np.unique(np.concatenate([special, rand]))[:max(n, len(special))]


@pytest.mark.parametrize("n", [0, 1, 9, 1000, 60000])
def test_build_matches_jax(n):
    keys = _keys(n, n) if n else np.zeros(0, np.uint64)
    vals = np.random.default_rng(n + 1).integers(1, 1000, size=len(keys)).astype(np.int32)
    want = jhashmap.build_hash_map(keys, vals)
    got = hashmap.build_hash_map(keys, vals)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


@pytest.mark.parametrize("seed", [3, 4])
def test_depth_map_from_hashes_matches_jax(seed):
    """Zeros count (every invalid k-mer), masked windows do not."""
    rng = np.random.default_rng(seed)
    hashes = rng.choice(_keys(seed, 500), size=(40, 90)).astype(np.uint64)
    hashes[rng.random(hashes.shape) < 0.1] = 0
    mask = rng.random(hashes.shape) < 0.8
    want = jhashmap.depth_map_from_hashes(hashes, mask)
    for got in (hashmap.depth_map_from_hashes(hashes, mask),
                hashmap.depth_map_from_hashes(hashes.view(np.int64)[mask])):
        for f in FIELDS:
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert want.values[want.used & (want.hash_hi == 0) & (want.hash_lo == 0)].sum() > 0


def _queries(keys: np.ndarray, seed: int) -> np.ndarray:
    """Every key, key 0 (present or not), misses among them."""
    rng = np.random.default_rng(seed)
    miss = rng.integers(0, 2**64 - 1, size=300, dtype=np.uint64, endpoint=True)
    miss = np.concatenate([miss, [2**63 + 5, 0xFFFFFFFF_7FFFFFFF, 0x7FFFFFFF_FFFFFFFF]])
    q = np.concatenate([keys, np.zeros(1, np.uint64), miss.astype(np.uint64)])
    return q[rng.permutation(len(q))]


@pytest.mark.parametrize("n,with_zero", [(20, True), (3000, True), (3000, False)])
def test_plain_lookup_matches_jax(n, with_zero):
    keys = _keys(n + 7, n)
    if not with_zero:
        keys = keys[keys != 0]
    vals = np.random.default_rng(n).integers(1, 2**31 - 1, size=len(keys)).astype(np.int32)
    m = jhashmap.build_hash_map(keys, vals)
    q = _queries(keys, n)
    want = np.asarray(jhashmap.hashmap_get(m.device_arrays(), jnp.asarray(q)))
    table = convert.hashmap_from_numpy(m.hash_hi, m.hash_lo, m.used, m.values, "cpu")
    assert table.shape == (len(m.used), 4) and table.dtype == torch.int32
    got = hashmap.hashmap_get(table, torch.from_numpy(q.view(np.int64)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # every key reads its value; key 0 reads 0 where the map lacks it
    assert np.array_equal(got.numpy()[np.isin(q, keys)], want[np.isin(q, keys)])
    assert (want[~np.isin(q, keys)] == 0).all()
    # shapes pass through
    q2 = torch.from_numpy(q[:200].view(np.int64)).reshape(10, 20)
    assert torch.equal(hashmap.hashmap_get_plain(table, q2), got[:200].reshape(10, 20))


def test_slots_match_the_jax_builds_uint32_arithmetic():
    """The two slots, taken in int64 in the port, equal the uint32 slots of
    rkmh_tpu/ops/hashmap.py:66-67 for halves at and above 2**31."""
    keys = _keys(11, 4000)
    T = 1 << 13
    lo, hi = keys.astype(np.uint32), (keys >> np.uint64(32)).astype(np.uint32)
    want1 = ((lo ^ np.uint32(0x9E3779B1)) * np.uint32(0x9E3779B1)) & np.uint32(T - 1)
    want2 = ((hi ^ np.uint32(0x85EBCA77)) * np.uint32(0x85EBCA77)) & np.uint32(T - 1)
    s1, s2 = hashmap.slots(torch.from_numpy(keys.view(np.int64)), T)
    assert np.array_equal(s1.numpy(), want1.astype(np.int64))
    assert np.array_equal(s2.numpy(), want2.astype(np.int64))
    assert (lo >= 2**31).any() and (hi >= 2**31).any()


def test_map_table_and_convert_agree_and_check_shapes():
    keys = _keys(5, 100)
    m = hashmap.build_hash_map(keys, np.arange(len(keys), dtype=np.int32))
    a = hashmap.map_table(m, "cpu")
    b = convert.hashmap_from_numpy(m.hash_hi, m.hash_lo, m.used, m.values, "cpu")
    assert torch.equal(a, b) and int(a[:, 3].sum()) == len(keys)
    with pytest.raises(ValueError, match="power of two"):
        convert.hashmap_from_numpy(m.hash_hi[:100], m.hash_lo[:100], m.used[:100],
                                   m.values[:100], "cpu")
    with pytest.raises(ValueError, match=r"\[T, 4\] int32"):
        hashmap.hashmap_get(a[:100], torch.zeros(3, dtype=torch.int64))


def test_library_name_follows_every_source_and_header(tmp_path):
    """The built library is named by a hash of the flags and of every
    source and header under csrc/, so a changed header (murmur3.cuh,
    hashmap.cuh) is not served by a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    assert {p.name for p in kernels.headers(csrc)} >= {"murmur3.cuh", "hashmap.cuh"}
    base = kernels.library_path(csrc)
    assert base == kernels.library_path()  # the copy names the checkout's library
    seen = {base}
    for name in ("murmur3.cuh", "hashmap.cuh", "call_scan.cu"):
        path = csrc / name
        text = path.read_bytes()
        path.write_bytes(text + b"\n// edited\n")
        seen.add(kernels.library_path(csrc))
        path.write_bytes(text)
        assert kernels.library_path(csrc) == base
    assert len(seen) == 4
    (csrc / "notes.txt").write_text("not a source")
    assert kernels.library_path(csrc) == base
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kernels.library_path(csrc) != base
