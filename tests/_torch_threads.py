"""One intra-op thread for torch in the port's tests.

pytest-xdist runs the suite in several worker processes side by side, and
torch's default gives each of them one intra-op thread per core, so the
workers oversubscribe the cores several times over and the TINY models'
small ops spend their time handing work between threads: on an 8-core
machine with the suite's 6 workers running, an rmsnorm of (8, 128, 64)
took ~34 ms at 8 threads and ~0.06 ms at 1, and the chaos CLI test
(``test_torch_serve_faults.py::test_cli_chaos``) 106 s and 1.6 s. Every
port test file imports this module right after torch. ``DEFAULT`` is
torch's own count, for a module whose cases depend on it.
"""
import torch

DEFAULT = torch.get_num_threads()
torch.set_num_threads(1)
