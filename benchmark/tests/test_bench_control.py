"""The control comes out not correct: the plain reference one precision below
the configuration's (fp8 for each value the bf16 path stores, int4 for the
int8 trunk), put in the program's place, reads past a limit of each cell.
The control is judged by the harness's own comparison, as a run of the
program is. The chip reads it at the cells' sizes (``python -m
benchmark.readings --control``); this holds it at a tiny size on the CPU."""

import json

import pytest
from bench_tiny import CELLS, run_tiny

from benchmark import harness


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    result, lines = run_tiny(cell, control=True)
    assert result["correct"] is True  # the program itself, at this size
    control = json.loads(lines[1])["control"]
    assert control["correct"] is False, control
    assert set(control["checks"]) == set(harness.load_limits(cell))
    assert any(c["value"] > c["limit"] for c in control["checks"].values())
