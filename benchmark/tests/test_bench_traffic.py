"""Each traffic kind draws the same requests from the same seed, and the
stream's mix sends every length once a block, whatever the seed."""
import pytest

import tiny
from harness.main import Run
from harness.spec import Cell

CELLS = ["ser-clip10s", "ser-stream-utter", "twoface-scene10s"]


def _first(cell, seed, n):
    run = Run(cell, seed, 1.0, False, "cpu")
    reqs = cell.driver().requests(run)
    return [next(reqs).params for _ in range(n)]


@pytest.mark.parametrize("w", CELLS)
def test_same_seed_same_requests(full_root, w):
    cell = Cell(full_root, w)
    big = 2 ** 31 + 12345
    assert _first(cell, big, 9) == _first(cell, big, 9)
    assert _first(cell, big, 9) != _first(cell, big + 1, 9)


@pytest.mark.parametrize("w", CELLS)
def test_same_inputs_from_the_same_request(full_root, w):
    cell = Cell(full_root, w)
    run = Run(cell, 5, 1.0, False, "cpu")
    req = next(cell.driver().requests(run))
    a, b = cell.driver().inputs(run, req.params), \
        cell.driver().inputs(run, req.params)
    for x, y in zip(a, b):
        assert (x == y).all() if hasattr(x, "shape") else x == y


def test_stream_blocks_hold_every_length_once():
    cell = Cell(tiny.REPO, "ser-stream-utter")
    lengths = cell.mix["lengths_s"]
    sr = cell.model["float"]["sampling_rate"]
    for seed in (0, 2 ** 31 + 7, 99):
        got = [p["samples"] // sr for p in _first(cell, seed,
                                                  3 * len(lengths))]
        for b in range(3):
            block = got[b * len(lengths):(b + 1) * len(lengths)]
            assert sorted(block) == sorted(lengths)


def _drawn(seed, n, count=2, longest=None):
    from harness.main import Sample
    s = Sample(seed, count, longest)
    most = 0
    for i in range(n):
        s.offer(i)
        s.keep(i, i)
        most = max(most, len(s.kept))
    return s.indices(), most


def test_the_sample_spans_the_whole_window():
    """The compared requests are drawn from the seed over every request
    the window completes, holding at most ``count`` + 1 outputs."""
    big = 2 ** 31 + 77
    assert _drawn(big, 60) == _drawn(big, 60)
    picks = [i for seed in range(big, big + 200)
             for i in _drawn(seed, 60)[0]]
    assert max(_drawn(s, 60)[1] for s in range(big, big + 20)) <= 3
    assert len(picks) == 400
    late = sum(i >= 30 for i in picks) / len(picks)
    assert 0.35 < late < 0.65
    assert _drawn(big, 1)[0] == [0]


def test_the_stream_sample_holds_one_of_the_longest():
    cell = Cell(tiny.REPO, "ser-stream-utter")
    driver = cell.driver()
    top = max(cell.mix["lengths_s"])
    for seed in (3, 2 ** 31 + 9):
        run = Run(cell, seed, 1.0, False, "cpu")
        from harness.main import sample_for
        s = sample_for(run, driver)
        for i in range(95):
            s.offer(i)
        assert any(driver._length(run, i) == top for i in s.indices())
