"""The control: the plain reference computed in float8 (the next precision
below the configurations' bf16) in the program's place has to come out as
not correct under each cell's limits. On the CPU at the cells' widths with
the depth, batch and lengths cut (float8's error grows with the width: at
a width of 64 it reads half of what it does at 768); on the card (marked
`cuda`) at the cells' own sizes, on three seeds, as the limits were set."""

import pytest

from benchmark import harness
from benchmark.calibrate import readings
from benchmark.tests import tiny


def _fails(numbers, limits):
    correct, _ = harness.compare(numbers, limits)
    return not correct


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_tiny(name):
    c = tiny.cell(name, widths=True)
    lines = readings(c, 2 ** 31 + 5, "cpu", 0.3, "control")
    program, control = (line["numbers"] for line in lines)
    assert not _fails(program, c.limits)
    assert _fails(control, c.limits), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_on_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    harness.run_env()
    c = harness.find_cell(name)
    for seed in (3_000_000_000, 3_000_007_919, 3_000_015_838):
        program, control = (line["numbers"] for line in
                            readings(c, seed, "cuda", 4.0, "control"))
        assert not _fails(program, c.limits), (seed, program)
        assert _fails(control, c.limits), (seed, control)
