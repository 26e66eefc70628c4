"""On the card, at a cell's own size: the program's answer within the
cell's limits, the control's (the reference in TF32) beyond one of them.
Skipped without a card."""

import io

import pytest

from benchmark.harness import manifest
from benchmark.readings import readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hic_5kb.chr21", "hic_5kb.diff"])
def test_program_within_and_control_beyond_the_limits(cuda, name):
    limits = manifest.find_cell(name).spec["limits"]
    lines = readings(name, [2**31 + 101], [2**31 + 202, 2**31 + 303],
                     device=cuda, out=io.StringIO())
    prog = [x for x in lines if x["side"] == "program"]
    ctrl = [x for x in lines if x["side"] == "control"]
    assert all(x[k] <= limits[k] for x in prog for k in limits)
    assert all(any(x[k] > limits[k] for k in limits) for x in ctrl)
