"""One thread budget per test process.

Under pytest-xdist every worker would otherwise start thread pools as wide
as the machine (torch's intra- and inter-op pools, OpenMP, MKL), so ``-n 6``
on 8 cores runs some fifty busy threads and each test many times slower
than alone.  Each process gets its share of the cores it may run on
instead: ``max(1, cores // workers)``, with ``workers`` the xdist worker
count (1 outside xdist).  Subprocesses a test starts inherit the share
through ``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS`` unless these are set
already, as the rank workers set them to 1.

This file sits at the rootdir, so pytest imports it before
``tests/conftest.py`` imports jax.
"""

import os

_CORES = len(os.sched_getaffinity(0))
_BUDGET = max(1, _CORES // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
if _BUDGET < _CORES:
    # only in a worker: the xdist controller (budget = cores) must leave the
    # variables unset, or its workers would inherit its value
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, str(_BUDGET))

import torch  # noqa: E402  (after the variables, which OpenMP reads once)

torch.set_num_threads(_BUDGET)
try:
    torch.set_num_interop_threads(_BUDGET)
except RuntimeError:  # inter-op work has started; its pool is fixed now
    pass
