"""The control fails: the plain reference in TF32 (the precision below the
configurations' float32) put in the program's place reads above a limit of
each cell, while the program reads below every limit. On the card, at the
cells' own sizes, whose limits these are (one seed each; a dozen and more:
``python3 portbench/control.py``)."""

import pytest

from portbench import control, harness
from portbench.tests.helpers import CELLS, benchmark, tiny_cell


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = harness.load_cell(name, benchmark())
    readings = control.control_readings(cell, 2**31 + 71, card)
    assert any(value > cell.limits[key] for key, value in readings.items()), readings
    run = harness.run_cell(cell, 2**31 + 72, 2.0, False, card)
    assert run.correct, run.checks


def test_control_readings_run_on_the_cpu():
    cell = tiny_cell("ares_ea.moments_step")
    readings = control.control_readings(cell, 5, "cpu")
    assert readings["reward_rel_err"] > cell.limits["reward_rel_err"]
