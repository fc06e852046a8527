"""Explicit device selection: ``cuda`` (the default) or ``cpu``."""

from __future__ import annotations

import torch

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
