"""Timing on the card: CUDA events (eager, or replayed from a CUDA graph),
the launch floor (an empty kernel in graph replay), and the card's name
and power limit."""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from rkmh_tpu_torch.ops import kernels

DIAG_LAUNCH_SOURCE = Path(__file__).resolve().parent / "diag_launch.cu"
# rkmh_diag_empty(sink, blocks, threads, stream)
EMPTY_KERNEL = kernels.Kernel("rkmh_diag_empty", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])


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


def cuda_graph_time_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device ms per call of fn: iters calls captured in one CUDA
    graph, replayed `replays` times between CUDA events.  An eager loop
    of a kernel that runs for tens of microseconds times its Python
    wrapper's launch path instead; the graph leaves only the device work.
    fn must launch on the current stream and not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def launch_floor_ms(device, blocks: int, threads: int, iters: int = 50) -> float:
    """Device ms per launch of a kernel that does nothing, on a grid of
    ``blocks`` x ``threads``, by CUDA-graph replay: no kernel with that grid
    runs faster on the card.  Builds ``diag_launch.cu`` at first use."""
    if EMPTY_KERNEL._fn is None:
        path = kernels.build([DIAG_LAUNCH_SOURCE], kernels.BUILD_DIR / "diag" / "libdiag_launch.so")
        EMPTY_KERNEL._fn = EMPTY_KERNEL.function(ctypes.CDLL(str(path)))
    sink = torch.empty(1, dtype=torch.int32, device=device)
    return cuda_graph_time_ms(lambda: EMPTY_KERNEL(sink, blocks, threads), iters)


def card_name_and_power_limit() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
