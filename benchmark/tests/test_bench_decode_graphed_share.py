"""The reader of ``decode_graphed_share.clip`` on the hand-built program
traces of ``test_bench_graphed_share``, with the decode's chunk spans in
the sampler's place: the share of the ``decode.chunk`` spans whose
``graphed`` count is 1, and no reading off the card, without the
program's spans, without decode chunks, or from a program whose spans
carry no ``graphed`` (the parent of the decode graphs)."""
import pytest

import tiny
from harness.spec import load_module
from test_bench_graphed_share import _run, _trace

READ = load_module(tiny.BENCH / "metrics" / "decode_graphed_share.clip.py",
                   "metric").read
SWAP = {"sample.chunk": "decode.chunk", "decode.chunk": "sample.chunk"}


def _decode_trace(graphed):
    """A clip whose ``decode.chunk`` spans carry ``graphed`` and whose
    one ``sample.chunk`` span has no such count."""
    trace = _trace(graphed)
    for s in trace["spans"]:
        s["name"] = SWAP.get(s["name"], s["name"])
    return trace


@pytest.mark.parametrize("graphed, share", [
    ((1, 1, 1, 1, 1), 100.0), ((0, 1, 1, 1), 75.0), ((0, 0, 0), 0.0)],
    ids=["all", "some", "none"])
def test_the_share_of_graphed_decode_chunks(graphed, share):
    assert READ(_run(_decode_trace(graphed))) == pytest.approx(share)


@pytest.mark.parametrize("run", [
    _run(_decode_trace((1, 1)), device="cpu"), _run(None),
    _run(_decode_trace(())), _run(_decode_trace((None, None)))],
    ids=["cpu", "no trace", "no chunks", "no graphed count"])
def test_no_reading(run):
    assert READ(run) is None
