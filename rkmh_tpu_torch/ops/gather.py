"""Lookup-table gathers along either axis of a 2-D int32 LUT.

Counterparts of the two Pallas kernels of ``scripts/bench_gather.py``:
``_dg(lut, idx, 0)`` in ``dg0_kernel`` (:97-110) and ``_dg(lut, idx, 1)``
in ``dg1_kernel`` (:140-141).  On a CPU tensor each is
``torch.take_along_dim``; on a CUDA tensor it is the matching kernel of
``csrc/lut_gather.cu`` (K4, K5).  K4 takes one of two routes, chosen by
the LUT's shape (``rows_variant``): the LUT staged whole in each block's
shared memory (``smem``) or read through the cache (``ldg``).  So does K5
(``lanes_variant``): a row of 128 values held in a warp's registers and
gathered by shuffles, 4 indices a lane at a time (``reg``), or any other
shape staged a row at a time in a block's shared memory (``smem``).  As with
the TPU kernels' ``PROMISE_IN_BOUNDS``, the kernels do not check the
indices: the caller keeps them in range.
"""

from __future__ import annotations

import torch

from rkmh_tpu_torch.ops import kernels

# LUT bytes up to which K4 stages the LUT in a block's shared memory
# (N * C * 4, so N <= 400 at C = 128: the sweep's N in {8, 64})
SMEM_LUT_BYTES = 200 * 1024
_SMEM_BYTES = 232448  # a block's dynamic shared memory on sm_90
ROUTES = ("smem", "ldg")  # K4's routes; the C entry point takes smem = 1 or 0
LANES_ROUTES = ("reg", "smem")  # K5's routes; the C entry point takes reg = 1 or 0
LANES_REG_C = 128  # the row width of K5's reg route: 4 values in each of 32 lanes


def lut_gather_rows_plain(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(lut, idx.long(), dim=0)


def lut_gather_lanes_plain(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(lut, idx.long(), dim=1)


def rows_variant(lut: torch.Tensor) -> str:
    """Which K4 route a LUT gets, from its shape alone: ``smem`` (staged
    whole, up to SMEM_LUT_BYTES) or ``ldg``."""
    return "smem" if lut.numel() * 4 <= SMEM_LUT_BYTES else "ldg"


def lanes_variant(lut: torch.Tensor, idx: torch.Tensor) -> str:
    """Which K5 route a contiguous LUT and idx get: ``reg`` for rows of
    LANES_REG_C values, M % 4 == 0 and both 16-byte aligned (so that a
    lane loads and stores 4 values at once; the output is a new tensor,
    aligned), else ``smem``."""
    aligned = (lut.data_ptr() | idx.data_ptr()) % 16 == 0
    return "reg" if lut.shape[1] == LANES_REG_C and idx.shape[1] % 4 == 0 and aligned else "smem"


def _check_int32_2d(lut, idx, name):
    if lut.dtype != torch.int32 or idx.dtype != torch.int32 or lut.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{name} takes 2-D int32 lut and idx, got {lut.dtype} "
                         f"{tuple(lut.shape)} and {idx.dtype} {tuple(idx.shape)}")
    if lut.device != idx.device:
        raise ValueError(f"{name}: lut and idx lie on {lut.device} and {idx.device}")


def _lut_gather_rows_cuda(lut, idx, route: str | None = None):
    """K4 by the route ``rows_variant`` gives the LUT's shape, or by
    ``route`` (the tests and benchmarks hold every route at one shape)."""
    _check_int32_2d(lut, idx, "lut_gather_rows")
    (N, C), M = lut.shape, idx.shape[0]
    if idx.shape[1] != C:
        raise ValueError(f"lut_gather_rows: idx has {idx.shape[1]} columns, lut {C}")
    route = rows_variant(lut) if route is None else route
    if route not in ROUTES or (route == "smem" and N * C * 4 > _SMEM_BYTES):
        raise ValueError(f"lut_gather_rows: no {route!r} route for a LUT of {N} x {C}")
    lut, idx = lut.contiguous(), idx.contiguous()
    out = torch.empty((M, C), dtype=torch.int32, device=lut.device)
    if M * C:
        kernels.LUT_GATHER_ROWS(lut, idx, out, N, C, M, int(route == "smem"), route=route)
    return out


def _lut_gather_lanes_cuda(lut, idx, route: str | None = None):
    """K5 by the route ``lanes_variant`` gives the shape, or by ``route``."""
    _check_int32_2d(lut, idx, "lut_gather_lanes")
    (N, C), M = lut.shape, idx.shape[1]
    if idx.shape[0] != N:
        raise ValueError(f"lut_gather_lanes: idx has {idx.shape[0]} rows, lut {N}")
    if C * 4 > _SMEM_BYTES:
        raise ValueError(f"lut_gather_lanes: a LUT row of {C} values does not fit "
                         "in shared memory")
    lut, idx = lut.contiguous(), idx.contiguous()
    variant = lanes_variant(lut, idx)
    route = variant if route is None else route
    if route not in LANES_ROUTES or (route == "reg" and variant != "reg"):
        raise ValueError(f"lut_gather_lanes: no {route!r} route for a LUT of {N} x {C} "
                         f"and {M} indices a row at these addresses")
    out = torch.empty((N, M), dtype=torch.int32, device=lut.device)
    if N * M:
        kernels.LUT_GATHER_LANES(lut, idx, out, N, C, M, int(route == "reg"), route=route)
    return out


def lut_gather_rows(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = lut[idx[i, j], j]: lut [N, C], idx [M, C] -> [M, C]."""
    if lut.device.type == "cuda":
        return _lut_gather_rows_cuda(lut, idx)
    if lut.device.type != "cpu":
        raise ValueError(f"no lut_gather_rows path for device {lut.device}")
    return lut_gather_rows_plain(lut, idx)


def lut_gather_lanes(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = lut[i, idx[i, j]]: lut [N, C], idx [N, M] -> [N, M]."""
    if lut.device.type == "cuda":
        return _lut_gather_lanes_cuda(lut, idx)
    if lut.device.type != "cpu":
        raise ValueError(f"no lut_gather_lanes path for device {lut.device}")
    return lut_gather_lanes_plain(lut, idx)
