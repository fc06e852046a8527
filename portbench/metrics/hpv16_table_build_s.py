"""Seconds a job spends building hpv16's tables: the laps of
``Hpv16Tables.setup_s`` summed, averaged over the window's jobs."""

from portbench.readers import job_mean


def read(rec: dict):
    return job_mean(rec, "tables_s")
