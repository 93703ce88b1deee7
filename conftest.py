"""Guards on every pytest run from the root of the repo, loaded before
tests/conftest.py starts numpy, jax or torch: each pytest-xdist worker's
thread pools fit its share of the cores, and every test phase has a time
limit.
"""

import faulthandler
import os
import signal
import sys

import pytest


def _fit_threads_to_workers():
    """Give each pytest-xdist worker its share of the cores, and return it.

    Left alone, each of six workers on eight cores opens torch, OpenBLAS
    and OpenMP pools eight wide, and the workers spend their time
    switching threads: one test took 200 s that way and 19 s with one thread.
    A worker sets ``OMP_NUM_THREADS``, ``OPENBLAS_NUM_THREADS`` and
    ``MKL_NUM_THREADS``, where unset, to ``cores // PYTEST_XDIST_WORKER_COUNT``
    (at least one), before numpy and torch load, so that its tests'
    subprocesses inherit them; torch then takes ``OMP_NUM_THREADS``.  Outside
    a worker this returns None and leaves the environment and torch alone
    (xdist's own process loads this file before it starts the workers).
    The tests compare the port with the reference inside one process, so
    the thread count moves no verdict.
    """
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(share))
    return int(os.environ["OMP_NUM_THREADS"])


THREADS = _fit_threads_to_workers()


def pytest_configure(config):
    # torch loads here, after tests/conftest.py has set up jax
    if THREADS is not None:
        import torch

        torch.set_num_threads(THREADS)


# Every test phase (setup, call, teardown) gets this many seconds, and a
# phase of the `slow` tier, whose full-sequence runs take minutes in one
# process, the second figure.  Past it, SIGALRM dumps every thread's stack
# and fails the phase, and the run goes on.  A phase stuck in native code,
# where the signal cannot land, is dumped and its process ended a minute
# later, so that a hang costs one test and not the whole run.
TIME_LIMIT_S = 300.0
SLOW_TIME_LIMIT_S = 3600.0


@pytest.hookimpl(wrapper=True)
def _with_time_limit(item):
    limit = SLOW_TIME_LIMIT_S if item.get_closest_marker("slow") else TIME_LIMIT_S

    def overran(signum, frame):
        faulthandler.dump_traceback(sys.stderr)
        pytest.fail(f"ran past the per-test limit of {limit:g} s")

    faulthandler.dump_traceback_later(limit + 60, exit=True)
    previous = signal.signal(signal.SIGALRM, overran)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _with_time_limit
