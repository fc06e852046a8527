"""rkmh_tpu_torch's exact hash map (call's depth map) against the JAX package.

Keys are made from a seed with numpy and fed to both packages.  The port
lays its keys out sorted under a directory of their top bits
(``ops/hashmap.SortedMap``); the JAX package places them in a cuckoo
table.  The function is the same: the port's map, read by the plain lookup
on the CPU, must give the JAX ``hashmap_get``'s values on every key, key
0, keys at or above 2**63, keys whose lo or hi half is at or above 2**31,
and misses, whether the port built it from the keys, from the hashes
(``depth_map_from_hashes``) or from the JAX map's arrays
(``convert.hashmap_from_numpy``).  Keys the JAX build cannot take (three
that agree in the low 31 bits of both halves, ROADMAP C7) are held against
a Python dict.  Tolerance: none (integers).  Also: the layout's parts, the
overflow of counts that do not fit a word, and the kernel library's name
following every source and header (a changed header builds anew), without
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


def _keys(seed: int, n: int) -> np.ndarray:
    """n distinct uint64 keys: 0, keys >= 2**63, keys whose lo or hi half
    is >= 2**31 or < 2**31, and random ones.  No three of them agree in
    the low 31 bits of both halves: the two slots of such keys coincide
    at every table size up to 2**31, and the JAX package's cuckoo build
    doubles its table without end (ROADMAP C7)."""
    rng = np.random.default_rng(seed)
    special = np.array([0, 1, 2**64 - 1, 0x80000000_00000005, 0x00000003_80000007,
                        0x9ABCDEF0_12345678, 0x7FFFFFFF_FFFFFFFE, 0xFFFFFFFF_00000002],
                       dtype=np.uint64)
    rand = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64, endpoint=True)
    return np.unique(np.concatenate([special, rand]))[:max(n, len(special))]


def _queries(keys: np.ndarray, seed: int) -> np.ndarray:
    """Every key, key 0 (present or not), misses among them: random ones,
    and neighbours of keys (the next key up and down, the same top bits)."""
    rng = np.random.default_rng(seed)
    miss = rng.integers(0, 2**64 - 1, size=300, dtype=np.uint64, endpoint=True)
    edge = np.array([2**63 + 5, 0xFFFFFFFF_7FFFFFFF, 0x7FFFFFFF_FFFFFFFF], np.uint64)
    miss = np.concatenate([miss, edge, keys[:50] + np.uint64(1), keys[-50:] - np.uint64(1)])
    q = np.concatenate([keys, np.zeros(1, np.uint64), miss])
    return q[rng.permutation(len(q))]


def _get(sm, q: np.ndarray) -> np.ndarray:
    got = hashmap.hashmap_get(sm, torch.from_numpy(q.view(np.int64)))
    assert got.dtype == torch.int32 and got.shape == q.shape
    return got.numpy()


def _jax_get(m, q: np.ndarray) -> np.ndarray:
    return np.asarray(jhashmap.hashmap_get(m.device_arrays(), jnp.asarray(q)))


@pytest.mark.parametrize("n", [0, 1, 9, 1000, 60000])
def test_build_matches_jax(n):
    """The port's build of n keys against the JAX build of the same keys,
    compared by what they hold: every key, key 0 and misses read the same
    value."""
    keys = _keys(n, n) if n else np.zeros(0, np.uint64)
    vals = np.random.default_rng(n + 1).integers(1, 1000, size=len(keys)).astype(np.int32)
    sm = hashmap.build_sorted_map(keys, vals)
    assert (sm.n, sm.bits) == (len(keys), hashmap.bucket_bits(len(keys)))
    q = _queries(keys, n)
    want = _jax_get(jhashmap.build_hash_map(keys, vals), q)
    assert np.array_equal(_get(sm, q), want)
    value = dict(zip(keys.tolist(), vals.tolist()))
    assert np.array_equal(want[np.isin(q, keys)], np.array(
        [value[x] for x in q[np.isin(q, keys)].tolist()], dtype=np.int32).reshape(-1))
    assert (want[~np.isin(q, keys)] == 0).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_depth_map_from_hashes_matches_jax(seed):
    """Zeros count (every invalid k-mer), masked windows do not."""
    rng = np.random.default_rng(seed)
    keys = _keys(seed, 500)
    hashes = rng.choice(keys, size=(40, 90)).astype(np.uint64)
    hashes[rng.random(hashes.shape) < 0.1] = 0
    mask = rng.random(hashes.shape) < 0.8
    want_map = jhashmap.depth_map_from_hashes(hashes, mask)
    q = _queries(keys, seed)
    want = _jax_get(want_map, q)
    for got in (hashmap.depth_map_from_hashes(hashes, mask),
                hashmap.depth_map_from_hashes(hashes.view(np.int64)[mask])):
        assert got.n == int(want_map.used.sum())
        assert np.array_equal(_get(got, q), want)
    assert want[q == 0][0] == int((hashes[mask] == 0).sum()) > 0


@pytest.mark.parametrize("n,with_zero", [(20, True), (3000, True), (3000, False)])
def test_plain_lookup_matches_jax(n, with_zero):
    """The plain lookup of a JAX map carried over (``convert``) against the
    JAX ``hashmap_get``."""
    keys = _keys(n + 7, n)
    if not with_zero:
        keys = keys[keys != 0]
    vals = np.random.default_rng(n).integers(1, 2**31 - 1, size=len(keys)).astype(np.int32)
    m = jhashmap.build_hash_map(keys, vals)
    q = _queries(keys, n)
    want = _jax_get(m, q)
    sm = convert.hashmap_from_numpy(m.hash_hi, m.hash_lo, m.used, m.values, "cpu")
    assert isinstance(sm, hashmap.SortedMap) and sm.n == len(keys)
    got = _get(sm, q)
    assert np.array_equal(got, want)
    assert (want[~np.isin(q, keys)] == 0).all()
    # shapes pass through
    q2 = torch.from_numpy(q[:200].view(np.int64)).reshape(10, 20)
    assert torch.equal(hashmap.hashmap_get_plain(sm, q2),
                       torch.from_numpy(got[:200]).reshape(10, 20))
    with pytest.raises(ValueError, match="four \\[T\\] arrays"):
        convert.hashmap_from_numpy(m.hash_hi[:10], m.hash_lo, m.used, m.values, "cpu")


def test_the_c7_triples_against_a_dict():
    """Keys that agree in the low 31 bits of both halves (0, 2**31, 2**63
    and more of them): the JAX cuckoo build never ends on three of them
    (ROADMAP C7); the sorted map takes them like any keys."""
    c7 = np.array([0, 0x80000000, 2**63, 2**63 + 0x80000000, 0x80000000_00000000 | 2**31,
                   0x80000000_80000000], dtype=np.uint64)
    keys = np.unique(np.concatenate([c7, _keys(7, 200)]))
    vals = np.random.default_rng(7).integers(1, 10**6, size=len(keys)).astype(np.int32)
    want = dict(zip(keys.tolist(), vals.tolist()))
    q = _queries(keys, 7)
    got = _get(hashmap.build_sorted_map(keys, vals), q)
    assert np.array_equal(got, np.array([want.get(x, 0) for x in q.tolist()], np.int32))
    assert all(got[q == k][0] == want[int(k)] for k in c7)


@pytest.mark.parametrize("n", [5, 3000])
def test_counts_past_the_word_go_to_the_overflow(n):
    """A count of 2**B - 1 or more (key 0's can reach the read count), or a
    negative value, is kept in the overflow; the others in their words."""
    keys = _keys(n + 100, n)
    rng = np.random.default_rng(n)
    vals = rng.integers(1, 200, size=len(keys)).astype(np.int32)
    sat = (1 << hashmap.bucket_bits(len(keys))) - 1
    vals[0] = 2**31 - 1  # key 0
    vals[1::7] = sat
    vals[2::11] = sat - 1
    vals[3::13] = -5
    sm = hashmap.build_sorted_map(keys, vals)
    over = (vals >= sat) | (vals < 0)
    assert sm.m == int(over.sum()) and np.array_equal(sm.ov_values.numpy(), vals[over])
    assert np.array_equal(sm.ov_keys.numpy().view(np.uint64), keys[over])
    q = _queries(keys, n)
    want = dict(zip(keys.tolist(), vals.tolist()))
    assert np.array_equal(_get(sm, q), np.array([want.get(x, 0) for x in q.tolist()], np.int32))


def test_the_layout_and_its_validator():
    keys = _keys(8, 5000)
    vals = np.arange(1, len(keys) + 1, dtype=np.int32)
    sm = hashmap.build_sorted_map(keys, vals)
    B = sm.bits
    assert B == max(hashmap.MIN_BITS, len(keys).bit_length() - 2)
    d = sm.dir.numpy()
    assert d[0] == 0 and d[-1] == len(keys) and (np.diff(d) >= 0).all()
    bucket = (keys >> np.uint64(64 - B)).astype(np.int64)
    assert np.array_equal(np.repeat(np.arange(1 << B), np.diff(d)), bucket)
    assert np.array_equal(sm.words.numpy().view(np.uint64) >> np.uint64(B),
                          keys & np.uint64((1 << (64 - B)) - 1))
    assert sm.part_bytes() == {"words": 8 * len(keys), "directory": 4 * ((1 << B) + 1),
                               "overflow": 12 * sm.m}
    flipped, values = hashmap.sorted_keys(sm)
    assert np.array_equal((flipped.numpy() ^ np.int64(-2**63)).view(np.uint64), keys)
    assert np.array_equal(values.numpy(), vals)
    assert torch.equal(sm.to("cpu").buf, sm.buf)
    for bad in (hashmap.SortedMap(sm.buf[:-1], B, sm.n, sm.m),
                hashmap.SortedMap(sm.buf.to(torch.int32), B, sm.n, sm.m),
                hashmap.SortedMap(sm.buf, B + 1, sm.n, sm.m)):
        with pytest.raises(ValueError, match="a depth map is one contiguous"):
            hashmap.hashmap_get(bad, torch.zeros(3, dtype=torch.int64))


def test_build_takes_only_sorted_unique_keys():
    with pytest.raises(ValueError, match="unique and sorted"):
        hashmap.build_sorted_map(np.array([5, 3], np.uint64), np.array([1, 1], np.int32))
    with pytest.raises(ValueError, match="unique and sorted"):
        hashmap.build_sorted_map(np.array([3, 3], np.uint64), np.array([1, 1], np.int32))
    with pytest.raises(ValueError, match="two \\[n\\] arrays"):
        hashmap.build_sorted_map(np.array([3], np.uint64), np.array([1, 1], np.int32))


def test_empty_map_and_empty_queries():
    sm = hashmap.depth_map_from_hashes(np.zeros(0, np.int64))
    assert sm.n == sm.m == 0
    q = torch.tensor([0, -1, 5], dtype=torch.int64)
    assert torch.equal(hashmap.hashmap_get(sm, q), torch.zeros(3, dtype=torch.int32))
    one = hashmap.depth_map_from_hashes(np.zeros(7, np.int64))
    assert torch.equal(hashmap.hashmap_get(one, q), torch.tensor([7, 0, 0], dtype=torch.int32))
    assert hashmap.hashmap_get(one, q[:0]).shape == (0,)


def test_library_name_follows_every_source_and_header(tmp_path):
    """The built library is named by a hash of the flags and of every
    source and header under csrc/, so a changed header (murmur3.cuh,
    hashmap.cuh, packed_kmer.cuh) is not served by a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    assert {p.name for p in kernels.headers(csrc)} >= {"murmur3.cuh", "hashmap.cuh",
                                                        "packed_kmer.cuh"}
    base = kernels.library_path(csrc)
    assert base == kernels.library_path()  # the copy names the checkout's library
    seen = {base}
    for name in ("murmur3.cuh", "hashmap.cuh", "packed_kmer.cuh", "call_scan.cu"):
        path = csrc / name
        text = path.read_bytes()
        path.write_bytes(text + b"\n// edited\n")
        seen.add(kernels.library_path(csrc))
        path.write_bytes(text)
        assert kernels.library_path(csrc) == base
    assert len(seen) == 5
    (csrc / "notes.txt").write_text("not a source")
    assert kernels.library_path(csrc) == base
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kernels.library_path(csrc) != base
