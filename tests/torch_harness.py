"""The test run's share of the machine: a pytest plugin that every
``test_torch_*`` module loads through ``pytest_plugins``.

Each xdist worker takes its share of the cores, as ``parallel/launch.py``
gives CPU ranks theirs: torch otherwise starts one OpenMP thread per core in
every worker, and six workers' pools on eight cores ran the port's small CPU
ops hundreds of times slower.  ``OMP_NUM_THREADS`` carries the share to the
subprocesses that tests start, unless they set their own.  An xdist worker
collects every module before it runs a test, so under the tier-1 command the
share and the time limit below hold for every test, the JAX side's too.

Every phase of a test (setup, call, teardown) runs under a time limit, so
that a hang fails its own test, with every thread's stack, and does not run
the whole suite into its timeout.
"""

import contextlib
import faulthandler
import os
import signal
import sys

import pytest
import torch

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
torch.set_num_threads(THREADS)

# About three times the slowest test's time under the tier-1 command.
TEST_TIME_LIMIT_S = 360


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the code inside with ``pytest.fail`` after ``seconds`` of wall
    time, dumping every thread's stack first (to file descriptor 2, which
    pytest captures into the test's report).  Runs on the main thread only,
    as SIGALRM does; pytest and its xdist workers run tests there.  A call
    stuck in native code is interrupted when it returns to Python."""

    def expire(signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        pytest.fail(f"test exceeded its time limit of {seconds} s",
                    pytrace=False)

    old_handler = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with time_limit(TEST_TIME_LIMIT_S):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit(TEST_TIME_LIMIT_S):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with time_limit(TEST_TIME_LIMIT_S):
        return (yield)
