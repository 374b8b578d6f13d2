"""Run one benchmark cell once, on the card:

    python3 portbench/run.py --workload serve-fused-closed --seed 7 \
        --seconds 20 --trace 0

The last line on standard output is the result (one JSON object); see
``core.py``.  The port's kernel libraries are built into ``build/kernels``
inside the checkout, so only a cell's first run in a checkout builds them.
The program runs with its own settings (PyTorch's default CPU thread
pool, as ``cli serve`` and ``cli train`` run it).
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT)]
os.environ["MSTLDM_KERNEL_BUILD_DIR"] = str(ROOT / "build" / "kernels")

from portbench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
