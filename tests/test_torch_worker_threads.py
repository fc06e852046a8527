"""Each test process runs torch on its share of the cores.

The root ``conftest.py`` gives every process ``max(1, cores // workers)``
threads, ``workers`` being pytest-xdist's worker count (1 outside xdist),
so ``-n 6`` does not start six machine-wide thread pools on one machine.
"""

import os

import torch


def test_worker_thread_budget():
    cores = len(os.sched_getaffinity(0))
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        assert torch.get_num_threads() == cores
    else:
        assert torch.get_num_threads() == max(1, cores // int(workers))
