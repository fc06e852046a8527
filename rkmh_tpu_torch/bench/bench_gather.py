"""Gather microbenchmark on one GPU: the port of ``scripts/bench_gather.py``.

    python -m rkmh_tpu_torch.bench.bench_gather

It sizes the table probes of the classify and hpv16 steps with the same
four sections and shapes as the JAX script (``scripts/bench_gather.py:59-178``):

  plain-S   the plain PyTorch row gather ``table[idx].sum()`` of B=16000 x
            W=149 bucket indices, swept over table geometry (the JAX
            script's "xla-S" baseline: XLA's gather there, PyTorch's here)
  k4-N      ``ops.gather.lut_gather_rows`` (K4, ``out[i,j] = lut[idx[i,j], j]``)
            on an [N, 128] int32 LUT, N in {8, 64, 512, 4096, 16384}; the
            line names the variant that ran (LUT staged in shared memory,
            ``smem``, or read through the cache, ``ldg``)
  k5        ``ops.gather.lut_gather_lanes`` (K5, ``out[i,j] = lut[i, idx[i,j]]``)
            at N = 512, idx in 0..127
  plain-taa the plain ``torch.take_along_dim(...).sum()`` at N = 16384

Times are CUDA events over many calls after warm-up (the JAX script's
fetch-closed loops worked around a remote TPU link and are not needed).
Every kernel line prints ``correct=`` against the plain version on the
card and numpy on the host, and a wrong result raises.  It needs a CUDA
device and fails without one.
"""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.bench.timing import card_name_and_power_limit, cuda_time_ms
from rkmh_tpu_torch.device import resolve_device
from rkmh_tpu_torch.ops.gather import (
    lut_gather_lanes,
    lut_gather_lanes_plain,
    lut_gather_rows,
    lut_gather_rows_plain,
    rows_variant,
)

B, W = 16000, 149                # reads x windows per batch (zika classify probe)
TABLES = ((32768, 10, "S2"), (32768, 20, "S4"), (8192, 10, "S2-small"), (131072, 10, "S2-big"))
K4_NS = (8, 64, 512, 4096, 16384)
K5_N = 512
TAA_N = 16384
ITERS = 50


def check_gather(kernel, plain, lut: torch.Tensor, idx: torch.Tensor, axis: int) -> bool:
    """Kernel output == plain version == numpy's take_along_axis."""
    got = kernel(lut, idx)
    want = np.take_along_axis(lut.cpu().numpy(), idx.cpu().numpy(), axis)
    return torch.equal(got, plain(lut, idx)) and np.array_equal(got.cpu().numpy(), want)


def _say(line: str) -> None:
    print(line, flush=True)


def main() -> list[dict]:
    """Run the four sections; returns one record per printed line."""
    dev = resolve_device("cuda")
    _say(f"# device: {torch.cuda.get_device_name(dev)}; nvidia-smi: "
         f"{card_name_and_power_limit()}")
    rng = np.random.default_rng(0)
    results = []

    def record(line: str, **rec) -> None:
        _say(line)
        results.append(rec)

    for nb, width, tag in TABLES:
        table = torch.from_numpy(rng.integers(0, 2**31, (nb, width)).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, nb, (B, W))).to(dev)
        ms = cuda_time_ms(lambda: table[idx].sum(dtype=torch.int32), ITERS)
        record(f"plain-{tag:9s} nb={nb:7d} width={width:3d} {ms:8.4f} ms "
               f"{B * W / ms / 1e3:9.1f} Mrow/s", name=f"plain-{tag}", ms=ms)

    def kernel_line(name, kernel, plain, lut, idx, axis, variant=""):
        ok = check_gather(kernel, plain, lut, idx, axis)
        ms = cuda_time_ms(lambda: kernel(lut, idx), ITERS)
        record(f"{name:9s} {variant:4s} {ms:8.4f} ms {idx.numel() / ms / 1e3:9.1f} Mgather/s "
               f"correct={ok}", name=name, ms=ms, correct=ok, variant=variant)
        if not ok:
            raise AssertionError(f"{name}: the kernel disagrees with the plain version")

    for N in K4_NS:
        lut = torch.from_numpy(rng.integers(0, 2**31, (N, 128)).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, N, (N, 128)).astype(np.int32)).to(dev)
        kernel_line(f"k4-{N}", lut_gather_rows, lut_gather_rows_plain, lut, idx, 0,
                    rows_variant(lut))

    lut = torch.from_numpy(rng.integers(0, 2**31, (K5_N, 128)).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 128, (K5_N, 128)).astype(np.int32)).to(dev)
    kernel_line("k5", lut_gather_lanes, lut_gather_lanes_plain, lut, idx, 1)

    lut = torch.from_numpy(rng.integers(0, 2**31, (TAA_N, 128)).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, TAA_N, (TAA_N, 128))).to(dev)
    ms = cuda_time_ms(lambda: torch.take_along_dim(lut, idx, dim=0).sum(dtype=torch.int32),
                      ITERS)
    record(f"plain-taa      {ms:8.4f} ms {idx.numel() / ms / 1e3:9.1f} Mgather/s",
           name="plain-taa", ms=ms)
    return results


if __name__ == "__main__":
    main()
