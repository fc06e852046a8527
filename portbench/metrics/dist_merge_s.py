"""Seconds a job spends merging the ranks' stripes into one process's
order: the program's ``dist.merge`` span (``dist_stream.merge_outputs``,
run in rank 0's recorded run), averaged over the window's jobs."""

from portbench.program_spans import mean_seconds


def read(rec: dict):
    return mean_seconds(rec, "dist.merge")
