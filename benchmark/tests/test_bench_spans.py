"""The program's spans laid over the device trace
(harness/program_spans.py) and the readers built on it, on a hand-built
trace: launch calls matched to device operations by correlation id, the
innermost of nested spans, the busy share's union, the three milestones
of the time to the first chunk adding up; and, on the CPU at a tiny size,
the traced run's second pass over its profiled requests, which records
the program's spans and leaves the run's sample and requests as they
were."""
import itertools
import math
from types import SimpleNamespace

import pytest
import torch

import tiny
from float_torch.utils import profiling
from harness.main import Run, sample_for
from harness.program_spans import (attribute, busy_share_in, program_trace,
                                   ttfc_parts)
from harness.spec import Cell, load_module

NEW = ["sample_busy_share.clip", "sample_launches_per_chunk.clip",
       "decode_busy_share.clip", "ttfc_encode_ms.stream",
       "ttfc_sample_ms.stream", "ttfc_decode_wire_ms.stream",
       "pin_ms_per_chunk.stream"]


def _span(id, parent, name, lo, hi, request=7):
    return {"id": id, "parent": parent, "request": request, "name": name,
            "lo": lo, "hi": hi, "attrs": {}}


def _trace() -> dict:
    """One stream, request 7, times in microseconds: its root up to the
    first yield (0-100), the encoders, a sampler and a decode chunk under
    it, then a second sampler and decode chunk after it."""
    spans = [_span(1, None, "generate_stream", 0, 100),
             _span(2, 1, "encode_image", 1, 10),
             _span(3, 2, "direction_qr", 5, 9),
             _span(4, 1, "encode_audio", 11, 20),
             _span(5, 1, "emotion", 21, 25),
             _span(6, 1, "sample.chunk", 26, 40),
             _span(7, 1, "decode.chunk", 41, 45),
             _span(8, 1, "wire.pin", 45, 47),
             _span(9, 1, "wire.wait", 50, 99),
             _span(10, None, "decode.chunk", 101, 105),
             _span(11, None, "sample.chunk", 106, 109),
             _span(12, None, "encode_image", 200, 210, request=8)]
    calls = [[2, 11, "cudaLaunchKernel"], [6, 12, "cudaLaunchKernel"],
             [12, 13, "cudaLaunchKernel"], [27, 14, "cudaLaunchKernel"],
             [28, 15, "cudaLaunchKernelExC"], [29, 16, "cudaMemcpyAsync"],
             [42, 17, "cuLaunchKernel"], [46, 18, "cudaMemcpyAsync"],
             [102, 19, "cudaLaunchKernel"], [107, 20, "cudaGraphLaunch"],
             [150, 21, "cudaLaunchKernel"]]
    ops = [[3, 8, 11], [8, 9, 12], [13, 30, 13], [30, 33, 14], [35, 50, 15],
           [50, 52, 16], [52, 60, 17], [60, 61, 18], [110, 112, 19],
           [115, 118, 20], [151, 152, 21], [70, 71, 99]]
    return {"spans": spans, "calls": calls, "ops": ops, "ttfc_s": [1e-4]}


def _reader(name):
    return load_module(tiny.BENCH / "metrics" / f"{name}.py", "metric").read


def _run(trace, device="cuda"):
    return SimpleNamespace(device=torch.device(device), program_trace=trace)


def test_calls_and_operations_take_the_innermost_open_span():
    calls, ops = attribute(_trace())
    owner = [s and s["id"] for _name, s in calls]
    assert owner == [2, 3, 4, 6, 6, 6, 7, 8, 10, 11, None]
    assert [s and s["id"] for _lo, _hi, s in ops] == [
        2, 3, 4, 6, 6, 6, 7, 8, 10, 11, None, None]


def test_busy_share_is_the_union_over_the_span_of_the_operations():
    tr = _trace()
    # 30-33, 35-50, 50-52, 115-118: 23 us busy of 88
    assert busy_share_in(tr, "sample.chunk") == pytest.approx(100 * 23 / 88)
    # 52-60, 110-112: 10 of 60
    assert busy_share_in(tr, "decode.chunk") == pytest.approx(100 * 10 / 60)
    # a child's operations are its parent's: 3-8, 8-9 of 3-9
    assert busy_share_in(tr, "encode_image") == pytest.approx(100.0)
    assert busy_share_in(tr, "nothing") is None


def test_ttfc_milestones_add_up_to_the_root():
    # E = 30, the encode_audio operation's end, past emotion's span;
    # S = 52, the first sampler chunk's memcpy, past its span's end
    (parts,) = ttfc_parts(_trace())
    assert parts == pytest.approx((0.030, 0.022, 0.048))
    assert sum(parts) == pytest.approx(0.100)


def test_each_new_reader_on_the_hand_built_trace(capsys):
    got = {name: _reader(name)(_run(_trace())) for name in NEW}
    assert got == pytest.approx({
        "sample_busy_share.clip": 100 * 23 / 88,
        "sample_launches_per_chunk.clip": 3 / 2,
        "decode_busy_share.clip": 100 * 10 / 60,
        "ttfc_encode_ms.stream": 0.030, "ttfc_sample_ms.stream": 0.022,
        "ttfc_decode_wire_ms.stream": 0.048,
        # wire.pin 45-47 us over two decode.chunk spans
        "pin_ms_per_chunk.stream": 0.001})
    assert "sum 0.1" in capsys.readouterr().err


@pytest.mark.parametrize("name", NEW)
def test_no_reading_off_the_card_or_without_the_programs_spans(name):
    assert _reader(name)(_run(_trace(), device="cpu")) is None
    assert _reader(name)(_run(None)) is None          # a program without
    bare = {"spans": [], "calls": _trace()["calls"], "ops": _trace()["ops"],
            "ttfc_s": []}
    assert _reader(name)(_run(bare)) is None


def _tiny_run(root, workload):
    cell = Cell(root, workload)
    run = Run(cell, 2 ** 31 + 23, 0.1, True, "cpu")
    run.sample = sample_for(run, cell.driver())
    run.build()
    return run


def test_the_second_pass_records_the_profiled_requests(tiny_root):
    run = _tiny_run(tiny_root, "ser-stream-utter")
    sample, requests = run.sample, run.requests
    trace = program_trace(run)
    assert program_trace(run) is trace                # made once a run
    assert run.sample is sample and run.requests is requests == []
    assert not sample.kept
    assert profiling.span("x") is profiling.span("y")  # the recorder is off
    n = run.mix["profile_requests"]
    roots = [s for s in trace["spans"] if s["name"] == "generate_stream"]
    assert len(roots) == n == len(trace["ttfc_s"])
    assert len({s["request"] for s in roots}) == n
    assert all(t is not None and t > 0 for t in trace["ttfc_s"])
    ids = {s["id"] for s in trace["spans"]}
    for s in trace["spans"]:
        assert s["lo"] <= s["hi"]
        assert s["parent"] is None or s["parent"] in ids
    names = {s["name"] for s in trace["spans"]}
    assert {"encode_image", "direction_qr", "encode_audio", "emotion",
            "sample.chunk", "decode.chunk"} <= names   # the wire's: the card
    # the window's profiled requests, 1 to profile_requests, by length:
    # ceil(T / clip) sampler chunks each
    f = run.model["float"]
    clip = round(f["wav2vec_sec"] * f["fps"])
    want = [math.ceil(r.params["samples"] / f["sampling_rate"] * f["fps"]
                      / clip) for r in itertools.islice(
                          run.cell.driver().requests(run), 1, n + 1)]
    got = [sum(s["name"] == "sample.chunk" and s["request"] == r["request"]
               for s in trace["spans"])
           for r in sorted(roots, key=lambda s: s["lo"])]
    assert got == want
    assert trace["ops"] == []                         # the CPU: none


def test_a_program_without_the_recorder_gives_no_trace(tiny_root,
                                                       monkeypatch):
    run = _tiny_run(tiny_root, "ser-clip10s")
    monkeypatch.delattr(profiling, "take")
    assert program_trace(run) is None


def test_a_traced_run_on_the_cpu_prints_no_new_metric(tiny_root, capsys):
    code, result, _err = tiny.run(tiny_root, "ser-stream-utter", capsys,
                                  trace=1)
    assert code == 0 and result["correct"]
    assert not set(result["metrics"]) & set(NEW)
