"""Host seconds a job spends in copies between host and device: the program's
``device.h2d`` (each batch's copy in) and ``device.fetch`` (the results out)
spans, summed, averaged over the window's jobs."""

from portbench.program_spans import mean_seconds


def read(rec: dict):
    return mean_seconds(rec, "device.h2d", "device.fetch")
