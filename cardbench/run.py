"""Run one cell of the benchmark once and print its result line.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, then ``check``: each number the
correctness check compared, beside its limit); the last lines of standard
error repeat those numbers.  It measures ``repro_torch`` (under ``src/``)
and exits non-zero, printing no result, without the cards, without the
program, or if JAX or the JAX package has been loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process, one host thread for torch's and numpy's CPU work: the engine's
# host loop is single-threaded, and idle pool threads only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from harness import guard, spec
    from harness.cell import log, run

    cell = spec.load_cell(a.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{a.workload} needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace), T_START, root=ROOT)
    except guard.ForbiddenImport as e:
        log(str(e))
        return 3
    del out["_readings"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
