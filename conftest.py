"""Guards for the tier-1 suite under tests/: one persistent JAX compilation
cache a run, and one time limit for each test.

The cache.  The JAX package's tests build a fresh engine per case at smoke
widths, and each engine jits its passes again (its jit cache is its own), so
the suite spends its time compiling.  A persistent cache keyed by the lowered
module, the compile options and the JAX version turns a repeated compile into
a read of the very executable a compile would build.  The run's first process
(xdist's controller, or pytest alone) makes one directory under
``tempfile.gettempdir()`` and names it in JAX's environment variables before
any worker starts or anything imports JAX; workers and the processes tests
spawn inherit them.  Each run starts cold and the directory is removed when
the run ends.  The cache has no bound on its size (~60 MB a run): with a
bound, JAX takes one file lock around every read and write and scans the
whole directory on every write, which serialises the workers for minutes a
run.  Without it, a read that races another worker's write of the same entry
finds it torn; JAX then warns and compiles, as it would have without the
cache.

The limit.  A test under tests/ whose setup or call runs past
``TIME_LIMIT_S`` fails with the stack of every thread, so that a hang fails
one test and names its line instead of cutting the run.
"""
import contextlib
import os
import shutil
import signal
import sys
import tempfile
import threading
import traceback

import pytest

# The slowest test takes ~130 s without the cache on 8 cores under 6 workers; the rank tests
# wait up to 240 s on their ranks and then join them, and fail with the ranks' own message first.
TIME_LIMIT_S = 600.0

# Only the tier-1 suite: cardbench/tests, also run from this root, waits on the card for longer.
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
_CACHE_DIR = pytest.StashKey[str]()


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller's environment is its own
        return
    cache_dir = config.stash[_CACHE_DIR] = tempfile.mkdtemp(prefix="jax-compile-cache-")
    os.environ.update(JAX_COMPILATION_CACHE_DIR=cache_dir,
                      JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                      JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")


def pytest_unconfigure(config):
    if _CACHE_DIR in config.stash:
        shutil.rmtree(config.stash[_CACHE_DIR], ignore_errors=True)


def _stacks(main_frame):
    names = {t.ident: t.name for t in threading.enumerate()}
    frames = {ident: frame for ident, frame in sys._current_frames().items()
              if ident != threading.main_thread().ident}
    out = ["Main thread:\n", *traceback.format_stack(main_frame)]
    for ident, frame in frames.items():
        out += [f"Thread {names.get(ident, ident)}:\n", *traceback.format_stack(frame)]
    return "".join(out)


@contextlib.contextmanager
def _time_limit(item):
    if os.path.commonpath([TESTS_DIR, str(item.path)]) != TESTS_DIR:
        yield
        return

    def overrun(signum, frame):
        pytest.fail(f"{item.nodeid} passed its time limit of {TIME_LIMIT_S:g} s (conftest.py).\n"
                    f"{_stacks(frame)}", pytrace=False)

    # A signal handler runs on the main thread, where xdist's workers run their tests.
    previous = signal.signal(signal.SIGALRM, overrun)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item):
        yield
