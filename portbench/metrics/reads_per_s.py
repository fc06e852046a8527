"""Reads of every job of the window over the window's wall seconds, from the
first timed job's start to the end of the job that crosses --seconds."""


def read(rec: dict):
    return sum(j["reads"] for j in rec["jobs"]) / rec["window_s"]
