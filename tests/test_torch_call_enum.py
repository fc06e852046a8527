"""``parallel/mesh.ShardedCallEnum`` against rkmh-tpu's
``sharded_call_enum_fn`` (``rkmh_tpu/parallel/mesh.py:507-551``).

rkmh-tpu runs on the virtual CPU devices tests/conftest.py gives JAX
(dp = 8 and 4); the port on ``(cpu,) * dp``, where K1 and K8 are their
plain versions.  The slices are ``__graft_entry__.py:282-297``'s: Pl =
(L - k) // dp positions a slice, each with a k-code halo.  The reference
(made from a seed, with runs of N) and its reads' depth map are the same
for both: the JAX map from the reads' window hashes, carried over to the
port's sorted map (``convert.hashmap_from_numpy``).  Tolerance: none; the
window depths, the [dp * Pl, k, 3] substitution depths and the [dp]
global max must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from rkmh_tpu.ops import hashmap as jhashmap
from rkmh_tpu.parallel.mesh import make_mesh as jax_mesh
from rkmh_tpu.parallel.mesh import sharded_call_enum_fn
from rkmh_tpu_torch import convert
from rkmh_tpu_torch.io.packing import encode_seqs
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain
from rkmh_tpu_torch.ops.hashmap import depth_map_from_hashes
from rkmh_tpu_torch.parallel.mesh import ShardedCallEnum, make_mesh

L = 1200


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(17)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), L)
    ref[300:306] = ord("N")
    reads = []
    for _ in range(120):  # reads of the reference with substitutions: uneven depths
        s = int(rng.integers(0, L - 150))
        r = ref[s: s + 150].copy()
        r[rng.random(150) < 0.02] = ord("G")
        reads.append(r.tobytes())
    codes, _ = encode_seqs([ref.tobytes()])
    return codes[0, :L], reads


@pytest.mark.parametrize("k,dp", [(12, 8), (16, 4), (33, 8)])
def test_sharded_call_enum_equals_jax(genome, k, dp):
    ref, reads = genome
    codes, lens = encode_seqs(reads)
    h = kmer_window_hashes_plain(torch.from_numpy(codes), k).numpy()
    mask = np.arange(h.shape[1])[None, :] < (lens - (k - 1))[:, None]
    m = jhashmap.depth_map_from_hashes(h.view(np.uint64), mask)
    Pl = (L - k) // dp
    slices = np.stack([ref[d * Pl: d * Pl + Pl + k] for d in range(dp)])

    fn = sharded_call_enum_fn(jax_mesh(devices=jax.devices()[:dp], dp=dp, tp=1), k)
    want = [np.asarray(x) for x in fn(slices, m.device_arrays())]
    table = convert.hashmap_from_numpy(m.hash_hi, m.hash_lo, m.used, m.values, "cpu")
    got = ShardedCallEnum(make_mesh((torch.device("cpu"),) * dp, dp=dp), table, k)(slices)
    for name, g, w in zip(("depth", "snp_depth", "max"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert np.array_equal(g.numpy(), w), name
    assert int(got[2][0]) == int(got[1].max()) > 0 and got[0].max() > 1


def test_sharded_call_enum_refuses_other_slices():
    table = depth_map_from_hashes(np.arange(1, 9, dtype=np.int64))
    enum = ShardedCallEnum(make_mesh((torch.device("cpu"),) * 2, dp=2), table, 12)
    with pytest.raises(ValueError, match=r"takes \[2, Pl \+ 12\] slices"):
        enum(np.zeros((4, 40), np.uint8))
