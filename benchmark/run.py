"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``workloads`` in the
root's ``BENCHMARK.json``; its traffic is ``benchmark/workloads/<cell>.json``,
whose ``driver`` names the module of ``benchmark/drivers/`` that runs it, and
its configuration is the file the manifest names. ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py``. The last line of standard output is the
result (one JSON object); the compared numbers and their limits are the
last lines of standard error. Exits non-zero, printing no result, without
the cards the cell asks for or when JAX was loaded.
"""

import time

_T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, is where imports resolve
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

from benchmark.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=_T_START))
