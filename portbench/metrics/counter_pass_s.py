"""Seconds a job spends in the -M counter pass: the program's ``counter.pass``
span (the first pass over the input, its wait on the parse included),
averaged over the window's jobs."""

from portbench.program_spans import mean_seconds


def read(rec: dict):
    return mean_seconds(rec, "counter.pass")
