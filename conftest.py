"""Give each pytest-xdist worker its share of the CPU.

Under xdist (``-n N``) each worker is a process of its own, and torch
starts one OpenMP thread per core in every one of them: N workers on C
cores run N * C threads, and the tests' time goes into their contention.
Here each worker gets ``max(1, C // N)`` threads, C the cores this process
may run on. The budget is set in the environment before the tests import
torch, so that the processes a test starts (the gloo ranks of the mesh
tests, the subprocesses of the dry-run tests) inherit it, and in torch
itself. Without xdist nothing changes, and a single run keeps every core.
"""
import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _threads = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = \
        str(_threads)
    import torch

    torch.set_num_threads(_threads)
