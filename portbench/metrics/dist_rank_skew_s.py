"""A job's slowest rank's run seconds less its fastest's, from the clocks
each rank reports (``jobs/dist_stream.py``: ``stats["rank_skew_s"]``),
averaged over the window's jobs."""

from portbench.readers import job_mean


def read(rec: dict):
    return job_mean(rec, "rank_skew_s")
