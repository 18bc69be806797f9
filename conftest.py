"""Share the machine's cores among pytest-xdist's workers.

Each worker's torch opens an intra-op pool of one thread per core, so n
workers run n threads per core and the port's CPU tests (thousands of small
ops each) spend their time contending for them. In a worker of a run with
more than one, torch gets its share of the cores instead. Outside xdist
nothing changes; JAX's threads are left as they are.
"""

import os


def pytest_configure(config):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
