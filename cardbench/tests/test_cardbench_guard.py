"""The import guard compares whole top-level names, and nothing the
benchmark loads brings JAX or the JAX package in."""
import json
import shutil
import subprocess
import sys

from harness import guard, spec


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.models", "numpy"]) == []
    assert guard.forbidden_loaded(["repro.models.transformer", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]
    assert guard.forbidden_loaded(["reprox", "jaxtyping"]) == []


def test_the_benchmark_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, limits\n"
            "from harness import cell, trace, check, guard\n"
            "import reference.llama\n"
            "import repro_torch.serving.batch_engine, repro_torch.models.transformer\n"
            "print(guard.forbidden_loaded())") % (str(spec.BENCH_DIR), str(spec.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: a
    non-zero exit and no result line."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "cardbench", ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload", cell, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
