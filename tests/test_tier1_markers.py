"""Guards of the Tier-1 command's reach and of the per-test time limit.

The Tier-1 command passes its own ``-m 'not slow'``, and pytest keeps only
the last ``-m``, so no marker expression in ``pytest.ini`` can keep a test
out of it. The multi-minute regression drives stay out because the root
``conftest.py`` marks every ``regression`` test ``slow`` as well.
"""

import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _collect(expression):
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-m", expression, "tests/"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    items = [line for line in out.stdout.splitlines() if "::" in line]
    return out, items


def test_no_regression_test_escapes_slow():
    out, items = _collect("regression and not slow")
    assert out.returncode == pytest.ExitCode.NO_TESTS_COLLECTED, (
        out.stdout + out.stderr)
    assert items == [], out.stdout


def test_regression_marker_still_collects_the_drives():
    out, items = _collect("regression")
    assert out.returncode == pytest.ExitCode.OK, out.stdout + out.stderr
    assert items, out.stdout


def test_time_limit_fails_the_test_by_name(request):
    time_limit = request.config.pluginmanager.get_plugin(
        os.path.join(ROOT, "conftest.py")).time_limit
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception) as failed:
        with time_limit(request.node.nodeid, 0.2):
            time.sleep(1)
    assert time.monotonic() - start < 0.9
    assert request.node.nodeid in str(failed.value)
    assert "time limit of 0.2 s" in str(failed.value)
