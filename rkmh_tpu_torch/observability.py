"""Observability: one JSON metrics line per run, and a profiler trace.

A copy of ``rkmh_tpu/observability.py`` with the same counters, timers,
JSON keys and rounding:

* ``RKMH_TPU_METRICS=1`` (or the CLI's ``--metrics``): on exit, one JSON
  line to stderr: the command, wall seconds, the reads and bp processed
  and their rates, plus any phase timers the command recorded.
* ``RKMH_TPU_PROFILE=<dir>``: the run inside ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present), its Chrome
  trace written into ``<dir>`` as ``trace.json``; open it in Perfetto or
  ``chrome://tracing`` for per-kernel device time.

Counters are process-wide plain numbers, reset at the start of each run;
the input layer counts reads and bp as batches are made, at the points
where rkmh-tpu counts them, so one input gives the same integers in both
packages.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

COUNTERS: dict[str, float] = defaultdict(float)
TIMERS: dict[str, float] = defaultdict(float)
TRACE_FILE = "trace.json"


def count(name: str, n: float) -> None:
    COUNTERS[name] += n


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        TIMERS[name] += time.perf_counter() - t0


def metrics_enabled() -> bool:
    return os.environ.get("RKMH_TPU_METRICS", "0") == "1"


def _profiler():
    """A ``torch.profiler.profile`` of CPU activity, and of CUDA activity
    where a card is present."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


@contextmanager
def observed_run(command: str, enabled: bool | None = None):
    """Wrap a command run: profiler trace + metrics line on exit."""
    enabled = metrics_enabled() if enabled is None else enabled
    profile_dir = os.environ.get("RKMH_TPU_PROFILE", "")
    prof = None
    if profile_dir:
        prof = _profiler()
        prof.__enter__()
    COUNTERS.clear()
    TIMERS.clear()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
            print(f"rkmh-tpu-torch: device trace written to {profile_dir}", file=sys.stderr)
        if enabled:
            line = {"command": command, "wall_s": round(wall, 3)}
            for k, v in sorted(COUNTERS.items()):
                line[k] = int(v)
                if wall > 0:
                    line[f"{k}_per_sec"] = round(v / wall, 1)
            for k, v in sorted(TIMERS.items()):
                line[f"t_{k}_s"] = round(v, 3)
            print(json.dumps(line), file=sys.stderr)
