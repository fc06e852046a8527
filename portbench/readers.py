"""What the per-layer metrics' files (``metrics/<name>.py``) read from a
traced run's record: ``trace`` (``trace.read_trace``, or None), ``work_bytes``
(the least bytes of the window's jobs, ``work``) and ``jobs`` (each window
job's stats from the program's own clocks).  A reader that finds nothing to
read returns None, and the metric is left out of the run's line."""

from __future__ import annotations

from portbench import work


def device_idle_pct(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernels_roofline(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or not rec.get("work_bytes"):
        return None
    return work.roofline_pct(rec["work_bytes"], t["kernel_s"])


def job_mean(rec: dict, key: str) -> float | None:
    vals = [j[key] for j in rec.get("jobs", []) if key in j]
    return sum(vals) / len(vals) if vals else None
