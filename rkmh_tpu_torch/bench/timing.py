"""Timing on the card: CUDA events, and the card's name and power limit."""

from __future__ import annotations

import subprocess

import torch


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn over iters calls, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_name_and_power_limit() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
