"""Seconds a job spends on its output: the program's ``output.format`` (results
to text) and ``output.emit`` (the text written) spans, summed, averaged over
the window's jobs."""

from portbench.program_spans import mean_seconds


def read(rec: dict):
    return mean_seconds(rec, "output.format", "output.emit")
