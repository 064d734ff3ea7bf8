"""On the card: a short run of every cell prints a sound result line, and the
fp8 control, read at the cell's own size, fails one of the cell's limits on three
seeds.  Run on a machine with an H100 from the root of a checkout:

    python3 -m pytest -q -p no:cacheprovider -m cuda cardbench/tests/test_cardbench_card.py
"""
import json
import subprocess
import sys
import time

import pytest
import torch

from harness import spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_run_prints_a_correct_result(cell):
    _card()
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload", cell, "--seed", str(2**31 + 901),
                          "--seconds", "8", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails_at_the_cells_size(cell):
    _card()
    from harness.cell import run

    numbers = spec.load_cell(cell).limits["numbers"]
    for seed in (2**31 + 911, 2**31 + 912, 2**31 + 913):
        out = run(cell, seed, 10.0, False, time.perf_counter(), controls=("fp8",))
        assert all(out["_readings"][name] <= lim["limit"] for name, lim in numbers.items())
        assert any(out["_readings"]["fp8_" + name] > lim["limit"] for name, lim in numbers.items())
        torch.cuda.empty_cache()
