"""The comparison that decides ``correct`` against a broken program: a
run on the CPU at a tiny size, with the timed path broken underneath
(``harness/faults.py``), comes out not correct, once for each fault the
cell's path can have; the sound run comes out correct."""
import pytest

import tiny
from harness.faults import BY_KIND, FAULTS

CELLS = ["ser-clip10s", "ser-stream-utter", "twoface-scene10s"]
CASES = [(w, f) for w in CELLS for f in BY_KIND[tiny.kind(w)]]


@pytest.mark.parametrize("w", CELLS)
def test_sound_run_is_correct(tiny_root, capsys, w):
    code, result, _ = tiny.run(tiny_root, w, capsys)
    assert code == 0 and result["correct"] is True


@pytest.mark.parametrize("w,fault", CASES)
def test_fault_is_not_correct(tiny_root, capsys, monkeypatch, w, fault):
    FAULTS[fault](monkeypatch.setattr)
    code, result, _ = tiny.run(tiny_root, w, capsys)
    assert code == 0 and result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
