"""portbench's tests: CPU checks of the harness and the reference at
small sizes; tests marked ``card`` need an NVIDIA card and skip without
one (decided inside each test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on the CPU")


def pytest_sessionstart(session):
    """One CPU thread per test process: the tests run side by side in
    several workers, and the serving tests' short windows must answer
    requests however many workers share the machine."""
    import torch
    torch.set_num_threads(1)
