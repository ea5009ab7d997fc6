"""On the card: the control (the program with TF32 matrix products and
convolutions switched on, the precision below the configuration's float32)
must come out not correct, and the program correct, on the same seed.
Short windows; ``slambench/control.py`` reads the same at the cells' own
length over several seeds."""

import time

import pytest

from slambench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["euroc-flight", "d455-walk"])
def test_control_is_refused_and_the_program_is_not(card, workload):
    seed = 2 ** 32 + 77
    seconds = 8.0
    ok, nums = harness.run_cell(workload, seed, seconds, False, time.time(), log=lambda m: None)
    bad, cnums = harness.run_cell(workload, seed, seconds, False, time.time(),
                                  log=lambda m: None, control=True)
    assert ok["correct"], nums
    assert not bad["correct"], cnums
