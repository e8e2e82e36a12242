"""The root ``conftest.py``: one intra-op thread, and the per-test wall limit.

The limit runs on a child pytest run of two files: the first holds a test
that sleeps past a 2 s limit, then a passing test; the second passing tests
only. The child's ``conftest.py`` takes the repository's hooks and sets the
limit. Under two xdist workers with ``--dist loadfile`` the sleeper must fail
by name, with its frame in the stack dump, and the run must end with every
other test passed. Without the marker file xdist hands the sleeper's file to
one new worker after another, and the sleeper runs past the limit again in
each until the restarts run out. Without xdist the stacks are dumped and the
sleeper runs to its end.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

CHILD_CONFTEST = f"""
import importlib.util

spec = importlib.util.spec_from_file_location("repo_conftest", {str(REPO / "conftest.py")!r})
repo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(repo)
repo.LIMIT = 2
globals().update((k, v) for k, v in vars(repo).items() if k.startswith("pytest_"))
"""

SLEEPER = """
import time


def test_sleeps_past_the_limit():
    time.sleep(5)


def test_after_the_sleeper():
    pass
"""

PASSING = """
def test_one():
    pass


def test_two():
    pass
"""


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1
    assert os.environ["OPENBLAS_NUM_THREADS"] == "2"


@pytest.mark.parametrize("workers", [2, 0])
def test_overrun_is_reported_by_name_and_the_run_goes_on(tmp_path, workers):
    (tmp_path / "conftest.py").write_text(textwrap.dedent(CHILD_CONFTEST))
    (tmp_path / "test_a.py").write_text(SLEEPER)
    (tmp_path / "test_b.py").write_text(PASSING)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_XDIST")}
    env["TMPDIR"] = str(tmp_path / "tmp")
    (tmp_path / "tmp").mkdir()
    xdist = ["-p", "xdist", "-n", str(workers), "--dist", "loadfile"] if workers else []
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", *xdist, "-p", "no:cacheprovider",
         "-p", "no:randomly", "-rfE", "test_a.py", "test_b.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = run.stdout + run.stderr
    assert f'File "{tmp_path / "test_a.py"}", line 6 in test_sleeps_past_the_limit' in out, out
    if workers:
        assert run.returncode == 1, out
        assert "FAILED test_a.py::test_sleeps_past_the_limit" in run.stdout, out
        assert "3 passed" in run.stdout, out
        assert run.stdout.count("node down") == 1, out
    else:
        assert run.returncode == 0 and "4 passed" in run.stdout, out
    assert not any((tmp_path / "tmp").glob("pytest-limit-*")), out
