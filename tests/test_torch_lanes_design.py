"""The premise of the K5 (lane gather) kernel's design, held against its
plain version and the gather microbenchmark's Pallas kernel on the CPU.

K5's register route (``gather_lanes_reg`` in csrc/lut_gather.cu) gives a
warp one row of a [N, 128] LUT: lane l holds row[4l .. 4l+3] in 4
registers, so row[j] sits in lane j >> 2, register j & 3, and an output is
4 shuffles from lane j >> 2 and a select on j & 3.  A pass gives each lane
one 16-byte load of 4 indices, so the route takes M % 4 == 0 on 16-byte
aligned tensors only; every lane runs every shuffle of a pass (a pass's
count is the warp's).  A numpy model of that layout must write every
output once, read no index past the row's end, and equal
``lut_gather_lanes_plain`` and ``dg1_kernel`` (``scripts/bench_gather.py:140``,
its body under ``pl.pallas_call(..., interpret=True)``) at the sweep's
[512, 128] and at ragged N and M.  Every other shape (another width C, M
% 4 != 0, or an unaligned tensor) takes the staged route (one block a row,
the row in shared memory), modelled the same way.

Inputs are made from a seed with numpy.  Tolerance: none (integers).
"""

import numpy as np
import pytest
import torch

from rkmh_tpu_torch.ops import gather

from test_torch_gather import _pallas_dg

LANES_WARPS = 4  # csrc/lut_gather.cu
LANES_THREADS = 128  # the staged route's block


def lanes_reg_model(lut: np.ndarray, idx: np.ndarray):
    """csrc/lut_gather.cu's reg route -> (out, times each output was
    written, shuffles a warp ran)."""
    N, C = lut.shape
    M = idx.shape[1]
    assert C == gather.LANES_REG_C and M % 4 == 0
    out = np.full((N, M), 0x5EED, dtype=np.int32)
    writes = np.zeros((N, M), dtype=np.int64)
    shuffles = 0
    blocks = -(-N // LANES_WARPS)
    for i in range(blocks * LANES_WARPS):
        if i >= N:  # the warps past the last row leave before any shuffle
            continue
        regs = lut[i].reshape(32, 4)  # lane l: row[4l .. 4l+3]
        for base in range(0, M, 4 * 32):
            x = np.zeros((32, 4), dtype=np.int64)
            for lane in range(32):
                j = base + 4 * lane
                if j < M:
                    assert j + 4 <= M, "a vector past the row's end"
                    x[lane] = idx[i, j: j + 4]
            shuffles += 16  # all 32 lanes, 4 registers, each of 4 values
            y = regs[x >> 2, x & 3]  # source lane j >> 2, register j & 3
            for lane in range(32):
                j = base + 4 * lane
                if j < M:
                    out[i, j: j + 4] = y[lane]
                    writes[i, j: j + 4] += 1
    return out, writes, shuffles


def lanes_staged_model(lut: np.ndarray, idx: np.ndarray):
    """The staged route: block i copies row i into shared memory, then its
    threads gather idx[i, t] for t = thread, thread + 128, ..."""
    N, C = lut.shape
    M = idx.shape[1]
    out = np.full((N, M), 0x5EED, dtype=np.int32)
    writes = np.zeros((N, M), dtype=np.int64)
    for i in range(N):
        shared = lut[i].copy()
        for t in range(LANES_THREADS):
            for j in range(t, M, LANES_THREADS):
                out[i, j] = shared[idx[i, j]]
                writes[i, j] += 1
    return out, writes


def _lut_idx(seed, N, C, M):
    rng = np.random.default_rng(seed)
    lut = rng.integers(-2**31, 2**31, (N, C)).astype(np.int32)
    idx = rng.integers(0, C, (N, M)).astype(np.int32)
    idx[0, 0], idx[-1, -1] = C - 1, 0
    return lut, idx


def _plain(lut, idx):
    return gather.lut_gather_lanes_plain(torch.from_numpy(lut), torch.from_numpy(idx)).numpy()


def test_row_j_sits_in_lane_j_over_4_register_j_mod_4():
    row = np.arange(128, dtype=np.int32) * 7
    regs = row.reshape(32, 4)
    for j in range(128):
        assert regs[j >> 2, j & 3] == row[j]


@pytest.mark.parametrize("N,M", [(512, 128), (1, 128), (7, 512), (9, 1000), (5, 4), (3, 4096)])
def test_reg_route_vectors_write_each_output_once(N, M):
    lut, idx = _lut_idx(N * 31 + M, N, 128, M)
    assert gather.lanes_variant(torch.from_numpy(lut), torch.from_numpy(idx)) == "reg"
    got, writes, shuffles = lanes_reg_model(lut, idx)
    assert (writes == 1).all()
    assert np.array_equal(got, _plain(lut, idx))
    # a pass covers 128 indices; no pass runs a shuffle for nothing
    assert shuffles == N * 16 * -(-M // 128)
    if (N, M) == (512, 128):
        assert np.array_equal(got, _pallas_dg(lut, idx, 1))


def _shifted(a: np.ndarray) -> torch.Tensor:
    """A copy of A 4 bytes past a 16-byte aligned allocation."""
    flat = torch.empty(a.size + 4, dtype=torch.int32)
    assert flat.data_ptr() % 16 == 0
    view = flat[1: a.size + 1].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


@pytest.mark.parametrize("N,M,shift", [(512, 128, True), (300, 77, False), (4, 1, False),
                                       (2, 3, False), (6, 130, False), (3, 700, True)])
def test_shapes_the_reg_route_refuses_take_the_staged_route(N, M, shift):
    """At C = 128, M % 4 != 0 or an unaligned idx or LUT goes to the staged
    route, which gives the same outputs."""
    lut, idx = _lut_idx(N * 37 + M, N, 128, M)
    lt, x = torch.from_numpy(lut), _shifted(idx) if shift else torch.from_numpy(idx)
    assert gather.lanes_variant(lt, x) == "smem"
    if shift:
        assert gather.lanes_variant(_shifted(lut), torch.from_numpy(idx)) == "smem"
        with pytest.raises(ValueError, match="no 'reg' route"):
            gather._lut_gather_lanes_cuda(lt, x, "reg")
    got, writes = lanes_staged_model(lut, idx)
    assert (writes == 1).all()
    assert np.array_equal(got, _plain(lut, idx))
    if M == 77:
        assert np.array_equal(got, _pallas_dg(lut, idx, 1))


@pytest.mark.parametrize("N,C,M", [(5, 1, 5), (7, 100, 64), (3, 256, 129), (2, 96, 300)])
def test_other_widths_take_the_staged_route(N, C, M):
    lut, idx = _lut_idx(N * 41 + C + M, N, C, M)
    assert gather.lanes_variant(torch.from_numpy(lut), torch.from_numpy(idx)) == "smem"
    got, writes = lanes_staged_model(lut, idx)
    assert (writes == 1).all()
    assert np.array_equal(got, _plain(lut, idx))
    assert np.array_equal(got, _pallas_dg(lut, idx, 1))


def test_the_sweep_shape_takes_the_reg_route():
    lut = torch.zeros((512, 128), dtype=torch.int32)
    assert gather.lanes_variant(lut, torch.zeros((512, 128), dtype=torch.int32)) == "reg"
    for C, M in ((100, 4), (128, 3)):
        with pytest.raises(ValueError, match="no 'reg' route"):
            gather._lut_gather_lanes_cuda(torch.zeros((4, C), dtype=torch.int32),
                                          torch.zeros((4, M), dtype=torch.int32), "reg")
    with pytest.raises(ValueError, match="no 'cache' route"):
        gather._lut_gather_lanes_cuda(lut, torch.zeros((512, 3), dtype=torch.int32), "cache")
