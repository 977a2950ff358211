"""The test harness itself (``torch_harness.py``): each xdist worker's share
of the cores, and the time limit on every phase of a test."""

import os
import signal
import time

import pytest
import torch

pytest_plugins = ("torch_harness",)


def _timer_left():
    return signal.getitimer(signal.ITIMER_REAL)[0]


@pytest.fixture
def harness(request):
    return request.config.pluginmanager.get_plugin("torch_harness")


@pytest.fixture
def timer_in_setup_and_teardown(harness):
    assert 0 < _timer_left() <= harness.TEST_TIME_LIMIT_S
    yield
    assert 0 < _timer_left() <= harness.TEST_TIME_LIMIT_S


def test_worker_takes_its_share_of_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, (os.cpu_count() or 1)
                                          // workers)


def test_time_limit_fails_and_restores_handler(harness):
    before = signal.getsignal(signal.SIGALRM)
    with pytest.raises(pytest.fail.Exception,
                       match="exceeded its time limit of 1 s"):
        with harness.time_limit(1):
            time.sleep(3)
    assert signal.getsignal(signal.SIGALRM) is before


def test_time_limit_is_armed_around_each_phase(harness,
                                              timer_in_setup_and_teardown):
    # the hooks' timer runs on this worker's main thread
    assert 0 < _timer_left() <= harness.TEST_TIME_LIMIT_S
