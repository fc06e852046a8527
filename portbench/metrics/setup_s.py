"""Seconds from the start of run.py to the first timed job: imports, CUDA
start, the kernel libraries' load (their build in a checkout's first run),
the inputs made or found, and one warm job."""


def read(rec: dict):
    return rec["setup_s"]
