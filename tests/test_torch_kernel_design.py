"""The premises of the K1 and K2 kernels' designs, held against the JAX
package on the CPU at small sizes.

(a) K2 gives equal hashes of a raw row their ranks from a per-read
open-addressing table, in whatever order the warp's atomics land.  A
numpy model of that table (claim a slot by value: the claimant takes
rank 0, later equal elements 1 + a count), fed the elements in shuffled
orders, must give the same
``lookup_intersection_counts_masked`` counts as ``prefix_eq_ranks``, and
both the same counts as the JAX package's ``lookup_intersection_counts
_masked`` with its prefix-equality ranks (``classify/engine.py:306-311``).

(b) K1 (k <= 32) takes the canonical strand from 2-bit keys packed per
block.  A numpy model of the packed kernel (ballot packing, funnel-shift
extraction, the reverse complement by bit reversal, ``fwd <= rc``, the
4-base ASCII table) must give the strand choice of ``_canonical_use_fwd``
and the words of ``_pack_words``, and hashes equal to the JAX package's
``kmer_window_hashes``.

Inputs are made from a seed with numpy.  Tolerance: none (integers).
"""

import numpy as np
import pytest
import torch

from rkmh_tpu.ops import hashing as jhashing
from rkmh_tpu.ops import lookup as jlookup
from rkmh_tpu_torch.ops.hashing import _canonical_use_fwd
from rkmh_tpu_torch.ops.intersect import prefix_eq_ranks
from rkmh_tpu_torch.ops.lookup import build_panel_table, lookup_intersection_counts_masked

U64 = np.uint64
M64 = U64(0xFFFFFFFFFFFFFFFF)
M64_INT = 2**64 - 1


# --------------------------------------------------------------------- (a)

def _table_ranks(row: np.ndarray, rng, nslots: int) -> np.ndarray:
    """Ranks of a raw row's valid (non-zero) elements as K2 assigns them
    (``insert_ranks`` in csrc/panel_probe.cu): the elements of each
    32-wide step in a random order (of the lanes that store into one empty
    slot in a round, any may win), each claiming or finding its value's
    slot (linear probing over nslots >= n slots; a key is the claimant's
    index + 1 beside a 17-bit fingerprint).  The claimant takes rank 0, a later
    equal element 1 + the slot's count of ranks >= 1 handed out."""
    n = row.size
    keys = np.zeros(nslots, np.int64)  # (index + 1) << 17 | fingerprint; 0 = empty
    count = np.zeros(nslots, np.int64)
    occ = np.zeros(n, np.int64)

    def insert_rank(h, i):  # as the kernel's
        mix = ((int(h) & M64_INT) * 0x9E3779B97F4A7C15) & M64_INT
        fp = mix & 0x1FFFF
        s = ((mix >> 32) * nslots) >> 32
        while True:
            if keys[s] == 0:
                keys[s] = ((i + 1) << 17) | fp
                return 0
            if keys[s] & 0x1FFFF == fp and row[(keys[s] >> 17) - 1] == h:
                count[s] += 1
                return count[s]
            s = (s + 1) % nslots

    for base in range(0, n, 32):
        lanes = np.array([i for i in range(base, min(base + 32, n)) if row[i] != 0], int)
        for i in lanes[rng.permutation(lanes.size)]:
            occ[i] = insert_rank(row[i], i)
    return occ


def _dup_rows(seed, n_rows=12, width=149):
    """Panel-drawn rows with planted duplicates (one value up to 40 times,
    a row of one value) and zeros, and a row of distinct values, plus a
    panel whose sketches repeat."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=60, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))
    R = 40
    sk = np.sort(rng.choice(pool, size=(R, 64)).view(np.uint64), axis=1)
    sk[0, :40] = sk[0, 0]  # a reference holding one value 40 times
    sk = np.sort(sk, axis=1)
    rows = rng.choice(pool, size=(n_rows, width))
    rows[0, rng.permutation(width)[:40]] = sk[0, 0].view(np.int64)
    rows[1] = sk[0, 0].view(np.int64)
    rows[rng.random(rows.shape) < 0.1] = 0
    # a row of distinct valid values, some in the panel: at one slot an
    # element, the table fills up
    rows[-1] = rng.integers(1, 2**63, size=width)
    rows[-1, :30] = pool[:30]
    return sk, rows, R, rng


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("slots_per_elem", [1, 3])  # a full table, and the usual 3n
def test_table_ranks_give_prefix_rank_counts(seed, slots_per_elem):
    sk, rows, R, rng = _dup_rows(seed)
    table = torch.from_numpy(build_panel_table(sk).table.view(np.int32))
    x = torch.from_numpy(rows)
    valid = x != 0
    want = lookup_intersection_counts_masked(x, valid, prefix_eq_ranks(x), table, R)
    occ = prefix_eq_ranks(x).numpy()
    jax_table = jlookup.build_panel_table(sk).table
    jax_want = np.asarray(jlookup.lookup_intersection_counts_masked(
        rows.view(np.uint64), rows != 0, occ.astype(np.uint32), (jax_table,), R))
    assert np.array_equal(want.numpy(), jax_want)
    assert int(want[1, 0]) >= 40  # ranks 0..39 of the repeated value all hit
    assert np.unique(rows[-1]).size == rows.shape[1]  # the row that fills a table
    for _ in range(3):  # three shuffles
        ranks = np.stack([_table_ranks(r, rng, slots_per_elem * r.size) for r in rows])
        got = lookup_intersection_counts_masked(x, valid, torch.from_numpy(ranks), table, R)
        assert torch.equal(got, want)
        # the same multiset of (value, rank) pairs per row, in another order
        for r, a, b in zip(rows, ranks, occ):
            v = r != 0
            assert sorted(zip(r[v], a[v])) == sorted(zip(r[v], b[v]))


# --------------------------------------------------------------------- (b)

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=U64)
_SPREAD = ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF), (4, 0x0F0F0F0F0F0F0F0F),
           (2, 0x3333333333333333), (1, 0x5555555555555555))
_PAIRS = U64(0x5555555555555555)


def _spread(v):
    x = v.astype(U64)
    for sh, m in _SPREAD:
        x = (x | (x << U64(sh))) & U64(m)
    return x


def _brev64(x):
    out = np.zeros_like(x)
    for j in range(8):
        out |= _REV8[(x >> U64(8 * j)) & U64(0xFF)] << U64(56 - 8 * j)
    return out


def _ballot(pred):  # [words, 32] bool -> [words] uint64 holding 32 bits
    return (pred.astype(U64) << np.arange(32, dtype=U64)).sum(axis=1, dtype=U64)


def _ascii4():
    acgt = np.array([65, 67, 71, 84], dtype=U64)
    v = np.arange(256)
    return sum(acgt[(v >> (6 - 2 * j)) & 3] << U64(8 * j) for j in range(4)).astype(U64)


def packed_k1_model(codes: np.ndarray, k: int, pt: int = 1024):
    """The packed variant of csrc/window_hash.cu, block by block (pt
    windows each), in numpy
    -> ([B, W] valid, [B, W] use_fwd, 4 x [B, W] little-endian words)."""
    B, L = codes.shape
    W, total = L - k + 1, B * (L - k + 1)
    flat, ascii4 = codes.reshape(-1), _ascii4()
    valid = np.zeros(total, bool)
    use_fwd = np.zeros(total, bool)
    words = np.zeros((4, total), U64)
    drop = U64(64 - 2 * k)
    for f0 in range(0, total, pt):
        fl = min(f0 + pt, total) - 1
        r0, r1 = f0 // W, fl // W
        w0 = f0 - r0 * W
        g0 = r0 * L + w0
        span = fl - f0 + 1 + (r1 - r0 + 1) * (k - 1)
        nwords = -(-span // 32) + 1
        c = np.full(nwords * 32, 255, np.uint8)
        c[:span] = flat[g0 : g0 + span]
        c = c.reshape(nwords, 32)
        fwd = _brev64(_spread(_ballot(c & 2 != 0)) | (_spread(_ballot(c & 1 != 0)) << U64(1)))
        bad = _ballot(c >= 4)
        tid = np.arange(fl - f0 + 1)
        dr = (w0 + tid) // W
        p = tid + dr * (k - 1)
        q = p >> 5
        funnel = ((bad[q] | (bad[q + 1] << U64(32))) >> (p & 31).astype(U64)) & U64(0xFFFFFFFF)
        ok = (funnel & U64((1 << k) - 1)) == 0
        s, i = ((2 * p) & 63).astype(U64), (2 * p) >> 6
        x = (fwd[i] << s) | ((fwd[i + 1] >> U64(1)) >> (U64(63) - s))
        x = (x >> drop) << drop
        rc = _brev64(x)
        rc = ((rc >> U64(1)) & _PAIRS) | ((rc & _PAIRS) << U64(1))
        rc = (rc ^ (M64 >> drop)) << drop
        fw = x <= rc
        canon = np.where(fw, x, rc)
        wd = np.zeros((4, tid.size), U64)
        for g in range(8):
            nb = k - 4 * g
            if nb <= 0:
                break
            a = ascii4[(canon >> U64(56 - 8 * g)) & U64(0xFF)]
            if nb < 4:
                a &= U64((1 << (8 * nb)) - 1)
            wd[g >> 1] |= a << U64(32 * (g & 1))
        sl = slice(f0, fl + 1)
        valid[sl], use_fwd[sl], words[:, sl] = ok, fw, wd
    return valid.reshape(B, W), use_fwd.reshape(B, W), words.reshape(4, B, W)


def _codes(seed, shape):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=shape).astype(np.uint8)
    c[rng.random(shape) < 0.03] = 4
    c[rng.random(shape) < 0.01] = 255
    c[0, :] = 0  # poly-A: its own reverse complement's mirror (T...T)
    return c


@pytest.mark.parametrize("k", range(1, 33))
def test_packed_k1_model_matches_jax(k):
    # rows of 60 codes, and rows of k + 2 (three windows: a block spans rows)
    for codes in (_codes(k, (9, 60)), _codes(100 + k, (100, k + 2))):
        W = codes.shape[1] - k + 1
        valid, use_fwd, words = packed_k1_model(codes, k)
        want_fwd = np.asarray(jhashing._canonical_use_fwd(codes, k, W))
        assert np.array_equal(use_fwd | ~valid, want_fwd | ~valid)
        assert torch.equal(_canonical_use_fwd(torch.from_numpy(codes).long() & 3, k, W)
                           .masked_fill(torch.from_numpy(~valid), True),
                           torch.from_numpy(want_fwd | ~valid))
        fw_plane = jhashing._ascii_from_codes(codes)
        rc_plane = jhashing._ascii_from_codes((3 - codes.astype(np.uint64)).astype(np.uint8) & 3)
        fws = jhashing._pack_words(fw_plane, list(range(k)), k, W)
        rcs = jhashing._pack_words(rc_plane, [k - 1 - p for p in range(k)], k, W)
        for j, (f, r) in enumerate(zip(fws, rcs)):
            want = np.asarray(np.where(want_fwd, f, r))
            assert np.array_equal(np.where(valid, words[j], 0), np.where(valid, want, 0)), j
        h1 = np.asarray(jhashing._murmur3_h1_from_words(list(words), k, 42))
        assert np.array_equal(np.where(valid, h1, U64(0)),
                              np.asarray(jhashing.kmer_window_hashes(codes, k)))
        assert valid.any() and (~valid).any()
