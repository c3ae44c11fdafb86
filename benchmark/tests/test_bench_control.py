"""The control of the comparison, the plain reference one step below the
configuration's precision in the program's place, comes out not correct:
on the CPU at a tiny size against the tiny limits, and (``cuda``) on the
card at the cell's own size against the cell's limits."""
import sys

import pytest

import tiny

CELLS = ["ser-clip10s", "ser-stream-utter", "twoface-scene10s"]
sys.path.insert(0, str(tiny.BENCH))
import calibrate  # noqa: E402


def _fails(root, w, device, seed):
    from harness.spec import Cell
    got = calibrate.readings(root, w, seed, "control", device)["numbers"]
    limits = Cell(root, w).limits
    assert set(got) == set(limits)
    return [k for k in got if got[k] > limits[k]]


@pytest.mark.parametrize("w", CELLS)
def test_control_fails_at_a_tiny_size(tiny_root, w):
    assert _fails(tiny_root, w, "cpu", 2 ** 31 + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("w", CELLS)
def test_control_fails_at_the_cells_size(card, full_root, w):
    assert _fails(full_root, w, card, 2 ** 31 + 5)
