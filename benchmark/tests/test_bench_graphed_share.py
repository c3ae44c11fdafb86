"""The reader of ``sample_graphed_share.clip`` on hand-built program
traces: the share of the ``sample.chunk`` spans whose ``graphed`` count
is 1, and no reading off the card, without the program's spans, without
sampler chunks, or from a program whose spans carry no ``graphed``."""
from types import SimpleNamespace

import pytest
import torch

import tiny
from harness.spec import load_module

READ = load_module(tiny.BENCH / "metrics" / "sample_graphed_share.clip.py",
                   "metric").read


def _trace(graphed, other=("decode.chunk",)):
    """One clip: its root, a ``sample.chunk`` span a count of ``graphed``
    (None: the span has no such count), then the ``other`` spans."""
    names = (["generate"] + ["sample.chunk"] * len(graphed) + list(other))
    flags = [None] + list(graphed) + [None] * len(other)
    spans = [{"id": i + 1, "parent": None if i == 0 else 1, "request": 1,
              "name": name, "lo": 10 * i, "hi": 10 * i + 5,
              "attrs": {} if g is None else {"index": i - 1, "graphed": g}}
             for i, (name, g) in enumerate(zip(names, flags))]
    return {"spans": spans, "calls": [], "ops": [], "ttfc_s": [None]}


def _run(trace, device="cuda"):
    return SimpleNamespace(device=torch.device(device), program_trace=trace)


@pytest.mark.parametrize("graphed, share", [
    ((1, 1, 1, 1, 1), 100.0), ((1, 0, 1, 1), 75.0), ((0, 0, 0), 0.0)],
    ids=["all", "some", "none"])
def test_the_share_of_graphed_chunks(graphed, share):
    assert READ(_run(_trace(graphed))) == pytest.approx(share)


@pytest.mark.parametrize("run", [
    _run(_trace((1, 1)), device="cpu"), _run(None), _run(_trace(())),
    _run(_trace((None, None)))],
    ids=["cpu", "no trace", "no chunks", "no graphed count"])
def test_no_reading(run):
    assert READ(run) is None
