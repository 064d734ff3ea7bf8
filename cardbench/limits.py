"""Read the correctness check's numbers over many seeds in one process, for
setting a cell's limits (``limits/<cell>.json``) by the rule in PERF.md.

    python3 cardbench/limits.py --workload <cell> --seeds 1,2,3 --seconds <s> [--controls fp8]

Each seed is one whole run of the cell (its own weights, traffic and
window), as ``run.py`` makes it; with ``--controls`` the check also reads
the gaps of the tokens the lower-precision reference puts first, the
target's at every served position and the draft's at the positions the
blocks reveal.  One JSON line a seed on standard output.  The benchmark's
own runs never read the controls.
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
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="", help="comma-separated control precisions of the family reference: fp8")
    a = ap.parse_args(argv)

    import torch

    from harness.cell import run

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    controls = tuple(c for c in a.controls.split(",") if c)
    t0 = T_START
    for seed in (int(s) for s in a.seeds.split(",")):
        out = run(a.workload, seed, a.seconds, False, t0, controls=controls)
        line = {"seed": seed, "correct": out["correct"], **out["_readings"],
                **{k: v["value"] for k, v in out["metrics"].items()}}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
