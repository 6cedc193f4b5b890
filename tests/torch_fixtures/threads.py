"""The CPU threads torch may use in a parity-test process.

Under pytest-xdist every worker would start one OpenMP thread per core;
the port's many small ops then spin against the other workers' threads,
and a system run takes several times longer than alone. Each worker takes
its share of the cores instead (one thread per worker at ``-n 6`` on eight
cores); a single process keeps them all."""

import os

import torch


def share_cores() -> int:
    """Set torch's intra-op threads to this process's share of the cores;
    returns the count (for a subprocess's OMP_NUM_THREADS)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n
