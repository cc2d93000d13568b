"""Run one benchmark cell once (see ``portbench/core.py``)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # import the harness as the package ``portbench``, and the port beside it

from portbench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
