"""Bound torch's intra-op threads in the port's CPU test processes.

pytest-xdist starts one worker per ``-n`` and sets
PYTEST_XDIST_WORKER_COUNT in each; every worker imports every test
module at collection.  Torch's default of one thread per core in each of
them oversubscribes the host (six 8-thread workers on 8 cores made one
frame test 50x slower than alone), so each worker takes its share of the
cores.  Every tests/test_torch_*.py imports this module; importing it
sets the bound once per process."""

import os

import torch


def bound_threads() -> int:
    """Set and return torch's intra-op thread count: the cores divided
    by the xdist worker count (all of them without xdist), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n


THREADS = bound_threads()
