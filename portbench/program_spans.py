"""Per-layer seconds from the program's own spans
(``rkmh_tpu_torch.observability``).  A traced run's window runs under the
profiler, so the tracer records each window job's command run; the warm
job, run before the profiler starts, is not recorded.  The last
``len(rec["jobs"])`` finished runs are then the window's jobs.  A program
without the tracer, fewer recorded runs than jobs, or no span of the names
asked for gives None."""

from __future__ import annotations


def window_runs(rec: dict) -> list | None:
    """The window's recorded runs, one a job, or None."""
    from rkmh_tpu_torch import observability

    finished = getattr(observability, "finished_runs", None)
    n = len(rec.get("jobs", []))
    runs = finished() if finished is not None and n else []
    return runs[-n:] if n and len(runs) >= n else None


def mean_seconds(rec: dict, *names: str) -> float | None:
    """The mean over the window's jobs of the summed seconds of the spans
    named ``names``."""
    runs = window_runs(rec)
    if runs is None:
        return None
    ns = [s.end_ns - s.start_ns for r in runs for s in r.spans if s.name in names]
    return sum(ns) * 1e-9 / len(runs) if ns else None
