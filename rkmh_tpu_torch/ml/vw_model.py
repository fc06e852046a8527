"""Reader + predictor for Vowpal Wabbit binary ``.model`` files.

A copy of ``rkmh_tpu/ml/vw_model.py`` (numpy only), kept because importing
any ``rkmh_tpu`` module imports JAX.  As in the JAX package, vw's blobs are
applied on the host: this module parses the 8.3.1 binary regressor format
and reimplements vw's own feature hashing and predict paths, so the
reference's four trained vw models (applied by its
model_docker/run_models.sh:3-10 through a vw-8.2 binary) drive predictions
without a vw binary.

File layout (verified byte-by-byte against all 4 shipped blobs —
every field below round-trips and the ``--interactions vv`` model's
weight section is exactly the dense 2^18 (u32 index, f32 weight)
sequence 0..262143):

    u32 n, n bytes      version string, nul-terminated ("8.3.1\\0")
    u32 n, n bytes      model id string (empty here)
    byte 'm'            model marker
    f32, f32            min_label, max_label
    u32                 num_bits (18 in all 4 blobs)
    u32, u32, u32       lda, ngram, skips (all 0 here)
    u32 n, n bytes      command-line options ("", " --ect 4 --error 0",
                        " --interactions vv", " --ect 9 --error 0")
    u32 = 4, u32        checksum block (ignored on read)
    byte                gd resume flag (0 = plain weights)
    (u32 i, f32 w)*     nonzero weights, ascending i < 2^num_bits

Weight-slot mapping (verified structurally: the ``--ect 4`` blob has NO
index ≡ 3 (mod 4) and the ``--ect 9`` blob uses all residues mod 8):
multi-problem reductions interleave per-problem weights,

    slot(h, p) = (h * wpp + p) mod 2^num_bits,

with wpp = next_pow2(num_problems) (ect with ``--error 0`` trains
k-1 single-elimination matches: ect4 -> wpp 4, ect9 -> wpp 8;
plain binary -> wpp 1).

vw feature hashing (clean-room from the documented vw behavior; the
constant-feature slot check in tests/test_model_docker.py and the
nonzero-slot hit-rate of features hashed from the bundled data validate
it against the shipped blobs):

* namespace hash  = hashstring(ns, 0)
* feature index   = all-digit names: int(name) + ns_hash  (mod 2^64 —
  rkmh's wabbit vectors use raw 64-bit hash values as feature names);
  otherwise MurmurHash3_x86_32(name, seed=ns_hash)
* constant feature index = 11650396 (vw constant.h), always present
* quadratic interaction index = left*27942141 + right (mod 2^64); for
  same-namespace pairs ("vv") the generation is combinations WITH the
  diagonal (j >= i) — vw's default no-permutations expansion.  (The
  diagonal convention is the one sub-detail not verifiable offline:
  the only shipped interactions model is dense, so every expansion
  hits a nonzero slot either way; noted in PARITY.md.)

ECT prediction (clean-room per the error-correcting-tournament
structure of vw's ect reduction at ``--error 0``): a single-elimination
bracket over labels 0..k-1 — round by round adjacent players pair
(odd player byes to the END of the next round), each match m = the
m-th created pair using base problem m; predict walks from the root
down, taking the RIGHT child when the match margin is > 0, and returns
leaf+1.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

QUADRATIC_CONSTANT = 27942141       # vw constant.h
CUBIC_CONSTANT = 21791
CUBIC_CONSTANT2 = 37663
CONSTANT_FEATURE = 11650396
_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# MurmurHash3_x86_32 (clean-room; golden-tested in tests/test_model_docker.py
# and tests/test_torch_wabbit.py)
# ---------------------------------------------------------------------------


def murmur3_x86_32(data: bytes, seed: int = 0) -> int:
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = struct.unpack_from("<I", data, 4 * i)[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[4 * nblocks:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def hashstring(name: str, seed: int) -> int:
    """vw's feature hasher: all-digit names are their integer value plus
    the seed (64-bit wraparound); anything else murmur-hashes with the
    seed.  Empty string -> seed."""
    if name and name.isdigit():
        return (int(name) + seed) & _M64
    return murmur3_x86_32(name.encode(), seed & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Model file
# ---------------------------------------------------------------------------


@dataclass
class VwModel:
    version: str
    min_label: float
    max_label: float
    bits: int
    options: str
    kind: str                 # "binary" | "ect"
    ect_k: int                # 0 for binary
    wpp: int                  # interleaved weights per feature slot
    interactions: list        # e.g. ["vv"]
    weights: np.ndarray       # dense [2^bits] float32

    @property
    def num_problems(self) -> int:
        return max(1, self.ect_k - 1) if self.kind == "ect" else 1


def is_vw_model(path: str) -> bool:
    """Cheap sniff: u32 version-string length <= 32 followed by a
    digits-and-dots version (np.savez files start with 'PK')."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(36)
    except OSError:
        return False
    if len(head) < 8 or head[:2] == b"PK":
        return False
    (n,) = struct.unpack_from("<I", head, 0)
    if not 2 <= n <= 32 or len(head) < 4 + n:
        return False
    v = head[4 : 4 + n].rstrip(b"\0")
    return bool(v) and all(c in b"0123456789." for c in v)


def load_vw_model(path: str) -> VwModel:
    d = open(path, "rb").read()
    off = 0

    def u32():
        nonlocal off
        (v,) = struct.unpack_from("<I", d, off)
        off += 4
        return v

    def nstr():
        nonlocal off
        n = u32()
        s = d[off : off + n].rstrip(b"\0").decode("latin1")
        off += n
        return s

    version = nstr()
    nstr()  # model id (empty in the shipped blobs)
    marker = d[off : off + 1]
    off += 1
    if marker != b"m":
        raise ValueError(f"{path}: missing 'm' model marker (got {marker!r})")
    min_label, max_label = struct.unpack_from("<ff", d, off)
    off += 8
    bits = u32()
    lda, ngram, skips = u32(), u32(), u32()
    if lda or ngram or skips:
        raise ValueError(
            f"{path}: lda/ngram models are not supported "
            f"(lda={lda} ngram={ngram} skips={skips})")
    options = nstr()
    cn = u32()
    off += cn      # checksum payload (not verified)
    off += 1       # gd resume flag
    if (len(d) - off) % 8:
        raise ValueError(f"{path}: weight section is not (u32,f32) pairs")
    pairs = np.frombuffer(d[off:], dtype=[("i", "<u4"), ("w", "<f4")])
    idx = pairs["i"].astype(np.int64)
    if len(idx) and (idx[-1] >= (1 << bits) or np.any(np.diff(idx) <= 0)):
        raise ValueError(f"{path}: weight indices not ascending < 2^{bits}")

    toks = options.split()
    ect_k = 0
    interactions = []
    for i, t in enumerate(toks):
        if t == "--ect" and i + 1 < len(toks):
            ect_k = int(toks[i + 1])
        elif t in ("--interactions", "-q") and i + 1 < len(toks):
            interactions.append(toks[i + 1])
    kind = "ect" if ect_k else "binary"
    problems = max(1, ect_k - 1) if ect_k else 1
    wpp = 1
    while wpp < problems:
        wpp *= 2

    weights = np.zeros(1 << bits, np.float32)
    weights[idx] = pairs["w"]
    return VwModel(version, min_label, max_label, bits, options, kind,
                   ect_k, wpp, interactions, weights)


# ---------------------------------------------------------------------------
# Featurization (vw-native hashing of ml.wabbit.Example records)
# ---------------------------------------------------------------------------


def example_vw_features(ex):
    """(idx [F] uint64, val [F] float32) arrays for one parsed Example,
    hashed exactly as vw would hash the same text line (namespaces,
    numeric-name fast path, constant feature — interactions are
    expanded separately per model).  Arrays, not pair lists: the dense
    vv-interactions model expands ~s^2 pairs per read, so the margin
    must stay a vectorized gather-dot (see _margin)."""
    idxs, vals = [CONSTANT_FEATURE], [1.0]
    for ns_name, fv in ex.namespaces:
        ns_hash = hashstring(ns_name, 0)
        for name, val in fv:
            idxs.append(hashstring(name, ns_hash))
            vals.append(val)
    return np.asarray(idxs, np.uint64), np.asarray(vals, np.float32)


def expand_interactions(ex, specs):
    """Quadratic namespace-product features (left*Q + right, mod 2^64)
    as (idx uint64, val float32) arrays.  Namespaces are selected by
    first letter, as vw does; the no-permutations expansion generates
    combinations WITH the diagonal over the matching namespaces — both
    within one namespace (feature pairs j >= i) and across distinct
    namespaces sharing the letter (each unordered namespace pair once,
    plus each namespace with itself)."""
    from itertools import combinations_with_replacement, product

    spaces = []
    for ns_name, fv in ex.namespaces:
        ns_hash = hashstring(ns_name, 0)
        idxs = np.asarray(
            [hashstring(name, ns_hash) for name, _ in fv], np.uint64)
        vals = np.asarray([v for _, v in fv], np.float32)
        spaces.append((ns_name, idxs, vals))

    out_idx, out_val = [], []
    for spec in specs:
        if len(spec) != 2:
            raise ValueError(f"unsupported interaction arity: {spec!r} "
                             "(the shipped models use pairs only)")
        slots = [[(n, ix, v) for n, ix, v in spaces if n[:1] == ch]
                 for ch in spec]
        if any(not s for s in slots):
            continue
        if spec[0] == spec[1]:
            # one letter twice: unordered namespace pairs incl. self
            combos = combinations_with_replacement(slots[0], 2)
        else:
            combos = product(*slots)
        Q = np.uint64(QUADRATIC_CONSTANT)
        for combo in combos:
            _, ia, va = combo[0]
            _, ib, vb = combo[1]
            if combo[0] is combo[1]:
                # same namespace: feature pairs j >= i (diagonal incl.)
                iu, ju = np.triu_indices(len(ia))
                left, right = ia[iu], ib[ju]
                v = va[iu] * vb[ju]
            else:
                left = np.repeat(ia, len(ib))
                right = np.tile(ib, len(ia))
                v = np.repeat(va, len(vb)) * np.tile(vb, len(va))
            out_idx.append(left * Q + right)  # uint64 wraparound = vw's
            out_val.append(v)
    if not out_idx:
        return (np.zeros(0, np.uint64), np.zeros(0, np.float32))
    return np.concatenate(out_idx), np.concatenate(out_val)


def _margin(model: VwModel, idx: np.ndarray, val: np.ndarray,
            problem: int) -> float:
    """Vectorized gather-dot: w[(h*wpp + p) mod 2^18] . v (uint64
    multiply wraps like vw's size_t arithmetic; the mask makes the
    wrap irrelevant anyway)."""
    mask = np.uint64((1 << model.bits) - 1)
    slots = ((idx * np.uint64(model.wpp) + np.uint64(problem)) & mask)
    return float(model.weights[slots.astype(np.int64)] @ val)


# ---------------------------------------------------------------------------
# ECT bracket (single elimination, --error 0)
# ---------------------------------------------------------------------------


def ect_bracket(k: int):
    """(directions, root): directions[node] = (left, right) for internal
    nodes (id >= k, in creation order — node id k+m uses base problem
    m); leaves are labels 0..k-1."""
    directions = {}
    players = list(range(k))
    next_id = k
    while len(players) > 1:
        nxt = []
        for i in range(0, len(players) - 1, 2):
            directions[next_id] = (players[i], players[i + 1])
            nxt.append(next_id)
            next_id += 1
        if len(players) % 2:
            nxt.append(players[-1])  # bye advances to the END
        players = nxt
    return directions, players[0]


def predict_ect(model: VwModel, idx, val) -> int:
    directions, root = ect_bracket(model.ect_k)
    node = root
    while node >= model.ect_k:
        left, right = directions[node]
        node = right if _margin(model, idx, val,
                                node - model.ect_k) > 0 else left
    return node + 1


# ---------------------------------------------------------------------------
# Line-level predict (the ml.wabbit CLI integration point)
# ---------------------------------------------------------------------------


def predict_examples(model: VwModel, examples, binary: bool = False):
    """Predictions for parsed Examples: ect -> class id; binary ->
    margin (or its sign with binary=True, vw's --binary)."""
    preds = []
    for ex in examples:
        idx, val = example_vw_features(ex)
        if model.interactions:
            ii, iv = expand_interactions(ex, model.interactions)
            idx = np.concatenate([idx, ii])
            val = np.concatenate([val, iv])
        if model.kind == "ect":
            preds.append(float(predict_ect(model, idx, val)))
        else:
            m = _margin(model, idx, val, 0)
            preds.append(float(1 if m > 0 else -1) if binary else m)
    return preds
