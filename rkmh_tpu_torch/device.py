"""Explicit device selection: ``cuda`` (the default) or ``cpu``; and the
host-to-device copy of a batch (``to_device``)."""

from __future__ import annotations

import numpy as np
import torch

from rkmh_tpu_torch.observability import span

DEFAULT_DEVICE = "cuda"


def resolve_device(name: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``name`` -> torch.device; raises on ``cuda`` without a GPU.

    The port never falls back to the CPU on its own: a run that asked for
    the GPU and cannot have it fails, so no CPU number can pass for a GPU
    one.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but CUDA is not available; "
                "pass device='cpu' (--device cpu) to run the plain path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(name)!r}: use 'cuda' or 'cpu'")


def to_device(arr: np.ndarray, device: torch.device, non_blocking: bool = True) -> torch.Tensor:
    """A host array copied to ``device``: the one road of a batch's
    host-to-device copy, in a ``device.h2d`` span of the array's bytes."""
    with span("device.h2d", arr.nbytes):
        return torch.from_numpy(arr).to(device, non_blocking=non_blocking)
