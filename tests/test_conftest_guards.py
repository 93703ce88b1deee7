"""The guards that the repo's root conftest.py puts on every run: each test
phase has a time limit, and each pytest-xdist worker's thread pools fit its
share of the cores."""

import os
import subprocess
import sys
import textwrap
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

_SLEEPER = textwrap.dedent(
    """
    import time


    def test_sleeps_past_the_limit():
        time.sleep(30)


    def test_runs_after_it():
        pass
    """
)


def _pytest_with_root_conftest(tmp_path, test_file: str, env: dict, limit: str = None):
    """Run pytest in a subprocess on `test_file`, in `tmp_path` beside a
    copy of the root conftest.py whose time limit is `limit` if given."""
    with open(os.path.join(REPO, "conftest.py")) as f:
        guards = f.read()
    if limit is not None:
        before = guards
        guards = guards.replace("TIME_LIMIT_S = 300.0", f"TIME_LIMIT_S = {limit}")
        assert guards != before
    (tmp_path / "conftest.py").write_text(guards)
    (tmp_path / "test_probe.py").write_text(test_file)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "test_probe.py"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120,
        env=dict(env, PYTHONPATH=REPO),
    )


def test_a_test_past_its_time_limit_fails_with_its_stack(tmp_path):
    """A test that sleeps past a 2 s limit fails with the sleeping frame's
    stack, and the run goes on to the next test."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_XDIST_")}
    start = time.monotonic()
    proc = _pytest_with_root_conftest(tmp_path, _SLEEPER, env, limit="2.0")
    elapsed = time.monotonic() - start
    out = proc.stdout + proc.stderr
    assert elapsed < 60, elapsed
    assert proc.returncode == 1, out[-4000:]
    assert "1 failed, 1 passed" in out, out[-4000:]
    assert "ran past the per-test limit of 2 s" in out
    # the faulthandler dump names the frame that was sleeping
    assert 'test_probe.py", line 6 in test_sleeps_past_the_limit' in out, out[-4000:]


def test_threads_fit_the_worker(tmp_path):
    """Inside an xdist worker, torch takes the worker's OMP_NUM_THREADS;
    in a worker of three whose environment sets no thread count, torch and
    the three variables hold cores // 3."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None:
        assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])
    share = max(1, len(os.sched_getaffinity(0)) // 3)
    probe = textwrap.dedent(
        f"""
        import os

        import torch


        def test_share():
            assert torch.get_num_threads() == {share}
            assert [os.environ[v] for v in {THREAD_VARS!r}] == ["{share}"] * 3
        """
    )
    env = {k: v for k, v in os.environ.items()
           if k not in THREAD_VARS and not k.startswith("PYTEST_XDIST_")}
    env["PYTEST_XDIST_WORKER_COUNT"] = "3"
    proc = _pytest_with_root_conftest(tmp_path, probe, env)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0 and "1 passed" in out, out[-4000:]
