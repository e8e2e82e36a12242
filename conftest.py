"""Settings for every test process: its thread counts and each test's wall limit.

pytest loads this file before ``tests/conftest.py``, so the thread counts are
set before jax, numpy or torch load their thread pools. It imports only the
standard library and pytest, so the test of the limit
(``tests/test_wall_limit.py``) can load it into a child run.
"""

import faulthandler
import hashlib
import os
import tempfile
from pathlib import Path

import pytest

# One intra-op thread per test process: xdist runs several workers on the
# host's cores, and the tests run small batches, where more threads only spin
# and contend. torch sizes its intra-op pool from OMP_NUM_THREADS, and OpenMP
# and MKL read these when they load; child processes inherit them.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
# OpenBLAS, the LAPACK under jax's CPU factorizations, gets two: at one thread
# the JAX package's validated walk rounds differently and falls
# (tests/test_golden.py, tests/test_engine_walking.py; ROADMAP.md, section C).
os.environ["OPENBLAS_NUM_THREADS"] = "2"

# Wall limit of one test, its fixtures' setup and teardown included: over
# twice the slowest test of `-m 'not slow'` on a cold cache (8 cores, six
# workers), for a slower host. Under xdist a test past it has every thread's
# stack dumped and its worker ended, so a hung XLA compile or torch op fails
# by name instead of holding its worker until the suite's own clock ends the
# run; faulthandler's timer acts inside native calls, which signal.alarm
# cannot interrupt. A run without xdist has no worker to spare: there the
# stacks are dumped and the test goes on. `slow` and `xslow` tests run
# unlimited.
LIMIT = 600

_STDERR = pytest.StashKey[int]()  # fd 2 as it was before pytest's capture took it over


def pytest_configure(config):
    config.stash[_STDERR] = os.dup(2)


def _running_marker(item):
    """File that exists while ``item`` runs under xdist, or None.

    xdist hands the file of a worker that was ended to a new worker, the
    test that ran past the limit included; finding its marker still there,
    that worker fails the test at once instead of waiting out the limit again.
    """
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return None
    name = hashlib.sha1(item.nodeid.encode()).hexdigest()
    return Path(tempfile.gettempdir(), f"pytest-limit-{run}-{name}")


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    if item.get_closest_marker("slow") or item.get_closest_marker("xslow"):
        return
    marker = _running_marker(item)
    if marker is not None:
        if marker.exists():
            pytest.fail(f"ran past the {LIMIT} s limit in a worker that was ended "
                        "for it; its stack dump is in the run's output", pytrace=False)
        marker.touch()
    faulthandler.dump_traceback_later(LIMIT, exit=marker is not None,
                                      file=item.config.stash[_STDERR])


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    yield
    faulthandler.cancel_dump_traceback_later()
    marker = _running_marker(item)
    if marker is not None:
        marker.unlink(missing_ok=True)
