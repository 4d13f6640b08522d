"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (``BENCHMARK.json``'s ``workloads``) names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``,
which names the entry, ``entries/<entry>.py``, and the generator); its
correctness limits are ``limits/<cell>.json``; each per-layer metric is read
by ``metrics/<metric>.py``.  Set-up, then a window of ``--seconds``, then
(``--trace 1``) a short profiled slice, then the comparison with the plain
reference (``reference/``).  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` with ``--trace 1``, then ``checks``); the compared numbers and
their limits are also the last lines of standard error.  Exits non-zero, with
no result line, without enough CUDA devices or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from portbench.harness.common import Phases, load_cell
    from portbench.harness.run import run_cell

    phases = Phases(T_START)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    phases.mark("python and torch")
    return run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", phases)


if __name__ == "__main__":
    sys.exit(main())
