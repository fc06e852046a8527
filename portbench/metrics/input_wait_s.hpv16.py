"""Seconds a job waits on its input: the program's ``input.wait`` spans (the
main thread blocked on the reader thread's queue), summed, averaged over the
window's jobs."""

from portbench.program_spans import mean_seconds


def read(rec: dict):
    return mean_seconds(rec, "input.wait")
