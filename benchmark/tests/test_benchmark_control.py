"""The control (the reference in the program's place, breaking one
guarantee of the configuration) comes out as not correct, at a size a
test run holds; on the card it is read at the cell's own size by
`python -m benchmark.control`."""
import pytest

from benchmark import control
from benchmark.tests.small import WORKLOADS, small_cell


@pytest.mark.parametrize("name", WORKLOADS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name, blocks=16, stratum=8, block_bytes=16384)
    r = control.reading(cell, 2**31 + 21, calls=6, device="cpu")
    assert r["checked_blocks"] > 0
    assert r["bad_blocks"] > r["limit"] and not r["correct"]
