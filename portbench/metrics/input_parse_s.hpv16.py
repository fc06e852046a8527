"""Seconds a job's input spends in the parser: the program's ``input.parse``
spans (the reader thread's busy time: the native parse and the copies out of
its batch, ``input.unpack``), summed, averaged over the window's jobs."""

from portbench.program_spans import mean_seconds


def read(rec: dict):
    return mean_seconds(rec, "input.parse")
