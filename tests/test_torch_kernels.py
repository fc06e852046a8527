"""The CUDA kernels of rkmh_tpu_torch against their plain PyTorch versions.

The kernel tests need an NVIDIA GPU (marker ``cuda``) and skip without
one.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)  Inputs
are made from a seed with numpy; tolerance: none, every output is an
integer and must be equal.
"""

import numpy as np
import pytest
import torch

from rkmh_tpu_torch.ops import kernels
from rkmh_tpu_torch.ops.hashing import kmer_window_hashes_plain, multi_k_window_hashes
from rkmh_tpu_torch.ops.lookup import build_panel_table
from rkmh_tpu_torch.ops.probe import panel_probe, panel_probe_plain
from rkmh_tpu_torch.ops.sketch import SENTINEL, bottom_s_sketch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(seed, shape):
    """Random codes with invalid ones (4, 5, 255) mixed in."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=shape).astype(np.uint8)
    c[rng.random(shape) < 0.02] = 4
    c[rng.random(shape) < 0.01] = 255
    return torch.from_numpy(c)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 8, 9, 12, 16, 17, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("L", [96, 400])  # one tile of windows, several tiles
def test_window_hash_kernel_matches_plain(cuda_device, k, L):
    codes = _codes(k + L, (48, L)).to(cuda_device)
    before = kernels.WINDOW_HASH.launches
    got = multi_k_window_hashes(codes, [k])
    torch.cuda.synchronize()
    assert kernels.WINDOW_HASH.launches == before + (k <= L)  # k > L: no windows
    assert got.shape == (48, max(L - k + 1, 0))
    assert torch.equal(got, kmer_window_hashes_plain(codes, k))


@pytest.mark.cuda
def test_window_hash_kernel_multi_k_and_short_rows(cuda_device):
    codes = _codes(3, (20, 160)).to(cuda_device)
    ks = [12, 16, 200, 33]  # k=200 > L contributes no columns
    got = multi_k_window_hashes(codes, ks)
    want = torch.cat([kmer_window_hashes_plain(codes, k) for k in ks], dim=-1)
    assert got.shape == (20, 149 + 145 + 128)
    assert torch.equal(got, want)


def _panel(seed, R, t, n_reads, width):
    """A table from sorted pool-drawn sketches, plus read rows."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=4 * t, dtype=np.int64)
    pool[::3] |= np.int64(-(2**63))  # high words >= 2**31
    sk = np.full((R, t), SENTINEL, dtype=np.int64)
    lens = rng.integers(t // 2, t + 1, R).astype(np.int32)
    for r in range(R):
        sk[r, : lens[r]] = np.sort(rng.choice(pool, lens[r]).view(np.uint64)).view(np.int64)
    table = torch.from_numpy(build_panel_table(sk, lens).table.view(np.int32))
    reads = rng.choice(np.concatenate([pool, rng.integers(1, 2**63, t, dtype=np.int64)]),
                       size=(n_reads, width))
    reads[rng.random(reads.shape) < 0.1] = 0  # invalid windows
    return table, torch.from_numpy(reads)


@pytest.mark.cuda
@pytest.mark.parametrize("R,width", [(1, 64), (40, 149), (300, 256), (60, 7000)])
def test_panel_probe_kernel_matches_plain(cuda_device, R, width):
    table, raw = _panel(R + width, R, 64, 96, width)
    table, raw = table.to(cuda_device), raw.to(cuda_device)
    # past 1000 the sketch keeps every element: a row of 7000 needs more
    # than the default 48 KB of shared memory
    sk, lens = bottom_s_sketch(raw, width if width > 1000 else width // 2)
    cases = [(sk, lens)] + ([(raw, None)] if width <= 256 else [])
    for rows, ln in cases:
        for md, mm in ((0, -1), (1, 3), (0, 30)):
            got = panel_probe(rows, ln, table, R, md, mm)
            torch.cuda.synchronize()
            want = panel_probe_plain(rows, ln, table, R, md, mm)
            assert torch.equal(got, want), (R, width, ln is None, md, mm)
    assert int(want[1].max()) > 0  # reads do match the panel


@pytest.mark.cuda
def test_panel_probe_kernel_edge_shapes(cuda_device):
    empty = torch.from_numpy(
        build_panel_table(np.full((3, 4), SENTINEL, np.int64), np.zeros(3, np.int32))
        .table.view(np.int32)).to(cuda_device)
    assert empty.shape[0] == 1  # one bucket: the bucket shift is 32
    rows = torch.randint(1, 2**62, (5, 12), device=cuda_device)
    assert torch.equal(panel_probe(rows, None, empty, 3, 0, -1),
                       panel_probe_plain(rows, None, empty, 3, 0, -1))
    none = torch.zeros((0, 12), dtype=torch.int64, device=cuda_device)
    assert panel_probe(none, None, empty, 3, 0, -1).shape == (3, 0)
    no_cols = torch.zeros((4, 0), dtype=torch.int64, device=cuda_device)
    assert torch.equal(panel_probe(no_cols, None, empty, 3, 0, -1),
                       panel_probe_plain(no_cols, None, empty, 3, 0, -1))


def test_library_is_keyed_by_sources_and_flags(monkeypatch):
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path == kernels.library_path()
    assert {p.name for p in kernels.sources()} == {"window_hash.cu", "panel_probe.cu"}
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path() != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_launch_counts_reset():
    kernels.WINDOW_HASH.launches = 3
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"window_hash": 0, "panel_probe": 0}
