"""Seconds a job's rank 0 spends in the -M counter's group reduction: the
program's ``dist.counter_reduce`` span (the table fetched to the host, one
gloo ``all_reduce``, the sums copied back), averaged over the window's
jobs."""

from portbench.program_spans import mean_seconds


def read(rec: dict):
    return mean_seconds(rec, "dist.counter_reduce")
