"""Run-wide test settings, for every test under the repository.

- A test marked ``regression`` (the multi-minute accuracy drives of
  ``tests/test_regression_suite.py``) is marked ``slow`` as well. pytest
  keeps only the last ``-m`` it is given, so a command with its own
  ``-m 'not slow'`` drops ``pytest.ini``'s ``-m "not regression"``; the
  ``slow`` marker keeps the drives out of it all the same.
  ``pytest tests/test_regression_suite.py -m regression`` still runs them.
- Every test has a wall-time limit of its own, ``TEST_TIME_LIMIT_S``.
- Under xdist each worker's torch gets its share of the CPUs this process
  may run on, rather than a thread for each of them.
"""

import faulthandler
import os
import signal
import sys
import time
from contextlib import contextmanager

import pytest

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# Each test's own wall-time limit, in seconds, its fixtures' set-up
# included: about three times the slowest test under the Tier-1 command
# (192-204 s with six workers on eight CPUs), since hosts have run up to
# three times slower than each other, and far under that command's 1,470 s.
TEST_TIME_LIMIT_S = 630


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: the ``-m`` expression is applied after this hook.
    for item in items:
        if item.get_closest_marker("regression"):
            item.add_marker(pytest.mark.slow)


@contextmanager
def time_limit(name, seconds):
    """Fail the running test, named ``name`` in the message, once ``seconds``
    of wall time have passed inside the block.

    The alarm fails the test at the next Python bytecode it runs, so code
    that never returns to the interpreter is left to the backstop in
    ``pytest_runtest_protocol``."""
    start = time.monotonic()

    def _expire(signum, frame):
        pytest.fail(f"{name} ran {time.monotonic() - start:.1f} s, past its "
                    f"time limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """Hold every test to ``TEST_TIME_LIMIT_S``, the set-up and tear-down of
    its fixtures included: the longest spans of a run are module-scoped
    reference drives, built in the set-up of a module's first test. A hang
    in native code (a gloo rendezvous, an XLA compile) never reaches the
    alarm's handler, so a minute later faulthandler ends the process (its
    thread dump goes to fd 2, which pytest captures unless run with ``-s``).
    xdist then fails the test, reports the worker down and starts another."""
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT_S + 60, exit=True,
                                      file=sys.__stderr__)
    try:
        with time_limit(item.nodeid, TEST_TIME_LIMIT_S):
            return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
