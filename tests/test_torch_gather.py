"""rkmh_tpu_torch LUT gathers vs numpy and the gather microbenchmark's
Pallas kernels.

``dg0_kernel`` / ``dg1_kernel`` are local to ``scripts/bench_gather.py``'s
``main()``, so their body (``lax.gather`` with the dimension numbers of
bench_gather.py:97-107) is repeated here under ``pl.pallas_call(...,
interpret=True)``, also at ragged shapes with M != N.  Inputs are made from a seed with numpy.  Tolerance:
none, the outputs are int32 and must be equal.
"""

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rkmh_tpu_torch.bench import bench_gather
from rkmh_tpu_torch.ops import gather


def _dg(x, idx, dim):
    dnums = lax.GatherDimensionNumbers(
        offset_dims=(),
        collapsed_slice_dims=(dim,),
        start_index_map=(dim,),
        operand_batching_dims=(1 - dim,),
        start_indices_batching_dims=(1 - dim,),
    )
    return lax.gather(x, idx[..., None], dnums, (1, 1),
                      mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS)


def _pallas_dg(lut, idx, dim):
    def kernel(lut_ref, idx_ref, out_ref):
        out_ref[:] = _dg(lut_ref[:], idx_ref[:], dim)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.int32), interpret=True,
    )(lut, idx))


def _lut_idx(seed, N, C, hi):
    rng = np.random.default_rng(seed)
    lut = rng.integers(-2**31, 2**31, (N, C)).astype(np.int32)
    return lut, rng.integers(0, hi, (N, C)).astype(np.int32)


@pytest.mark.parametrize("N", [8, 64])
@pytest.mark.parametrize("dim", [0, 1])
def test_gathers_match_the_pallas_kernels(N, dim):
    lut, idx = _lut_idx(N + dim, N, 128, N if dim == 0 else 128)
    fn = gather.lut_gather_rows if dim == 0 else gather.lut_gather_lanes
    got = fn(torch.from_numpy(lut), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _pallas_dg(lut, idx, dim))


@pytest.mark.parametrize("N", [1, 7, 8, 400, 401, 512, 4096, 16383, 16384])
@pytest.mark.parametrize("C", [1, 100, 128, 256])
def test_rows_gather_matches_the_pallas_kernel_at_ragged_shapes(N, C):
    # the shapes the CUDA tests hold each K4 route at, with M != N
    rng = np.random.default_rng(N * 3 + C)
    M = N + 37 if N < 4096 else N // 3
    lut = rng.integers(-2**31, 2**31, (N, C)).astype(np.int32)
    idx = rng.integers(0, N, (M, C)).astype(np.int32)
    idx[0] = N - 1
    got = gather.lut_gather_rows(torch.from_numpy(lut), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), _pallas_dg(lut, idx, 0))


@pytest.mark.parametrize("N,C,M", [(1, 128, 5), (512, 128, 512), (300, 32, 7)])
def test_gathers_match_numpy(N, C, M):
    rng = np.random.default_rng(N + C + M)
    lut = rng.integers(-2**31, 2**31, (N, C)).astype(np.int32)
    rows_idx = rng.integers(0, N, (M, C)).astype(np.int32)
    lanes_idx = rng.integers(0, C, (N, M)).astype(np.int32)
    got = gather.lut_gather_rows(torch.from_numpy(lut), torch.from_numpy(rows_idx))
    assert np.array_equal(got.numpy(), np.take_along_axis(lut, rows_idx, 0))
    got = gather.lut_gather_lanes(torch.from_numpy(lut), torch.from_numpy(lanes_idx))
    assert np.array_equal(got.numpy(), np.take_along_axis(lut, lanes_idx, 1))


def test_rows_variant_follows_the_lut_size():
    assert [gather.rows_variant(torch.zeros((n, 128), dtype=torch.int32))
            for n in bench_gather.K4_NS] == ["smem", "smem", "ldg", "ldg", "ldg"]


def test_kernel_wrappers_reject_what_they_cannot_take():
    lut = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        gather._lut_gather_rows_cuda(lut, torch.zeros((8, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="columns"):
        gather._lut_gather_rows_cuda(lut, torch.zeros((8, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        gather._lut_gather_lanes_cuda(lut, torch.zeros((4, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        gather._lut_gather_lanes_cuda(torch.zeros((1, 60000), dtype=torch.int32),
                                      torch.zeros((1, 4), dtype=torch.int32))


def test_rows_wrapper_rejects_a_route_the_lut_does_not_fit():
    idx = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="no 'smem' route"):
        gather._lut_gather_rows_cuda(torch.zeros((512, 128), dtype=torch.int32), idx, "smem")
    with pytest.raises(ValueError, match="no 'cluster' route"):
        gather._lut_gather_rows_cuda(torch.zeros((8, 128), dtype=torch.int32), idx, "cluster")
    with pytest.raises(ValueError, match="no 'tma' route"):
        gather._lut_gather_rows_cuda(torch.zeros((8, 128), dtype=torch.int32), idx, "tma")


def test_check_gather_finds_a_wrong_kernel():
    lut, idx = (torch.from_numpy(a) for a in _lut_idx(3, 64, 128, 64))
    assert bench_gather.check_gather(gather.lut_gather_rows, gather.lut_gather_rows_plain,
                                     lut, idx, 0)
    assert not bench_gather.check_gather(lambda a, b: gather.lut_gather_rows(a, b) + 1,
                                         gather.lut_gather_rows_plain, lut, idx, 0)


def test_bench_gather_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_gather.main()
