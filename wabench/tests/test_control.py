"""The control of each cell fails its limit where the program passes it:
the plain reference computed in tfloat32 (the precision below the
configurations' float32, which the port runs with TF32 off) put in the
program's place, at a size the CPU holds.  The limits' readings on the
card are in PERF.md."""

import pytest

from wabench import control
from wabench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_where_the_program_passes(name):
    c = tiny.cell(name)
    got = control.readings(c, 90210, 0.3, device="cpu")
    assert got["failed"] == 0 and got["control_precision"] == "tfloat32"
    for key, limit in c.limits.items():
        assert got["program"][key] <= limit
        assert got["control"][key] > limit
