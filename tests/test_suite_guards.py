"""The suite's own guards (conftest.py at the root of the repo), held in one
small pytest run under two xdist workers: a test past the time limit fails
with the guard's message and every thread's stack while one inside it
passes, and every worker of a run shares one JAX compilation cache under the
temporary directory, which is gone when the run ends."""
import os
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

import pytest

jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INNER_LIMIT_S = 5

REPORT_CACHE = """
import os

import jax


def test_cache_dir():
    cache_dir = jax.config.jax_compilation_cache_dir
    with open(os.path.join(os.environ["GUARD_OUT"], os.environ["PYTEST_XDIST_WORKER"]), "w") as f:
        f.write(cache_dir)
    jax.jit(lambda x: x + 1)(1)
    assert any(name.endswith("-cache") for name in os.listdir(cache_dir))
"""

LIMITS = """
import threading
import time


def test_overruns():
    threading.Thread(target=time.sleep, args=(60,), name="sleeper", daemon=True).start()
    time.sleep(60)


def test_within():
    time.sleep(0.2)
"""


@pytest.fixture(scope="module")
def inner_run(tmp_path_factory):
    """The suite's conftest, its limit cut to ``INNER_LIMIT_S``, over four
    tests in two files, run by ``-n 2 --dist loadfile``, which gives each
    worker one file."""
    root = tmp_path_factory.mktemp("guards")
    out, tests = root / "out", root / "tests"
    out.mkdir()
    tests.mkdir()
    with open(os.path.join(ROOT, "conftest.py")) as f:
        source = f.read()
    assert source.count("TIME_LIMIT_S = 600.0\n") == 1
    (root / "conftest.py").write_text(source.replace("TIME_LIMIT_S = 600.0\n", f"TIME_LIMIT_S = {INNER_LIMIT_S}\n"))
    (root / "pytest.ini").write_text("[pytest]\naddopts = --strict-markers\ntestpaths = tests\n")
    (tests / "test_a.py").write_text(REPORT_CACHE + LIMITS)
    (tests / "test_b.py").write_text(REPORT_CACHE)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["GUARD_OUT"] = str(out)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
         "--dist", "loadfile", "--junitxml", str(root / "junit.xml")],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    cases = {f'{tc.get("classname")}::{tc.get("name")}': tc
             for tc in ET.parse(root / "junit.xml").getroot().iter("testcase")}
    reports = {worker.name: worker.read_text() for worker in out.iterdir()}
    return proc, cases, reports


def test_time_limit_fails_an_overrun_and_passes_a_test_inside_it(inner_run):
    proc, cases, _ = inner_run
    assert proc.returncode == 1, proc.stdout + proc.stderr
    failure = cases["tests.test_a::test_overruns"].find("failure")
    assert failure is not None, proc.stdout
    assert f"tests/test_a.py::test_overruns passed its time limit of {INNER_LIMIT_S} s" in failure.text
    assert "Main thread:" in failure.text and "Thread sleeper:" in failure.text
    assert "time.sleep(60)" in failure.text  # the main thread's stack, down to the test's line
    assert not list(cases["tests.test_a::test_within"]), proc.stdout  # no failure, error or skip


def test_workers_of_a_run_share_one_compile_cache_that_ends_with_it(inner_run):
    proc, cases, reports = inner_run
    assert not list(cases["tests.test_a::test_cache_dir"]), proc.stdout
    assert not list(cases["tests.test_b::test_cache_dir"]), proc.stdout
    assert sorted(reports) == ["gw0", "gw1"], proc.stdout
    (cache_dir,) = set(reports.values())
    assert os.path.dirname(cache_dir) == tempfile.gettempdir()
    assert not os.path.exists(cache_dir)  # the controller removed it when the run ended
    here = jax.config.jax_compilation_cache_dir  # and this run has one of its own
    assert os.path.dirname(here) == tempfile.gettempdir() and os.path.isdir(here) and here != cache_dir
