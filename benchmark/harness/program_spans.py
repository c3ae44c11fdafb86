"""The program's own spans (``float_torch.utils.profiling``) laid over the
device trace, for the per-layer metrics that read them.

``program_trace(run)`` is read after the window of a traced run, once per
run: it serves the cell's profiled requests (1 to ``profile_requests``,
the window's own) once more on the cell's own path, with the program's
span recorder on and ``torch.profiler`` recording.  What it keeps, in
microseconds on the profiler's clock, which is the spans' clock too:
``spans``, the program's spans as dicts (``id``, ``parent``, ``request``,
``name``, ``lo``, ``hi``, ``attrs``); ``ops`` [start, end, correlation id]
of each device operation; ``calls`` [start, correlation id, name] of each
host CUDA call that has one (a launch, a copy, an allocation, a wait);
and ``ttfc_s``, the time to the first chunk that each served request
measured on the host clock (None where it has none).  The outputs of
these requests are not kept: the sample held against the reference is
the window's.  None where the program has no span recorder, or where the
requests failed.
"""
from __future__ import annotations

import itertools
import sys
import time
import traceback

import torch

from .main import Sample
from .trace import _union

MARK = "benchmark.program_spans"    # the host range around the stretch


def program_trace(run):
    """The run's program trace (see the module), made at the first call."""
    if "program_trace" not in vars(run):
        run.program_trace = collect(run)
    return run.program_trace


def collect(run):
    from float_torch.utils import profiling
    if not hasattr(profiling, "take") or run.pipe is None:
        return None
    driver = run.cell.driver()
    n = int(run.mix.get("profile_requests", 1))
    reqs = list(itertools.islice(driver.requests(run), 1, n + 1))
    # on the card, the device's activity alone: its operations and the
    # host's CUDA calls, without the host's operator events
    acts = [torch.profiler.ProfilerActivity.CUDA
            if run.device.type == "cuda" else
            torch.profiler.ProfilerActivity.CPU]
    kept, run.sample = run.sample, Sample(run.seed, 0)
    t0 = time.perf_counter()
    try:
        run.sync()
        profiling.tracing_on()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(MARK):
                for req in reqs:
                    driver.serve(run, req)
                run.sync()
        taken = profiling.take()
    except Exception:                       # noqa: BLE001 - shown, no reading
        traceback.print_exc(file=sys.stderr)
        return None
    finally:
        profiling.tracing_off()
        run.sample = kept
    ops, calls = _raw(prof)
    print(f"[program spans] {len(reqs)} requests, {len(taken.spans)} spans "
          f"({taken.dropped} dropped), {len(ops)} device operations, "
          f"{len(calls)} CUDA calls, in {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    return {"spans": [{"id": s.id, "parent": s.parent, "request": s.request,
                       "name": s.name, "lo": s.start_ns * 1e-3,
                       "hi": s.end_ns * 1e-3, "attrs": dict(s.attrs)}
                      for s in taken.spans],
            "ops": ops, "calls": calls,
            "ttfc_s": [getattr(r, "ttfc", None) for r in reqs]}


def _raw(prof) -> tuple:
    """(ops, calls) of the profiler's raw results, as the module says."""
    ops, calls = [], []
    for ev in prof.profiler.kineto_results.events():
        on_device = getattr(ev.device_type(), "name",
                            str(ev.device_type())) != "CPU"
        name, corr = ev.name(), ev.correlation_id()
        if on_device and (getattr(ev, "is_user_annotation", bool)()
                          or name == MARK or name.startswith("float.")):
            continue           # a host range's shadow on the device
        lo = ev.start_ns() * 1e-3
        if on_device:
            ops.append([lo, lo + ev.duration_ns() * 1e-3, corr])
        elif corr and name.startswith("cu"):
            calls.append([lo, corr, name])
    return ops, calls


def attribute(trace) -> tuple:
    """([(name, span)] of each host CUDA call, [(start, end, span)] of
    each device operation), ``span`` the innermost program span (an entry
    of trace["spans"]) open when the call ran, None where none was.  A
    device operation takes the span of its launch call, matched by their
    correlation id."""
    spans = sorted(trace.get("spans", []), key=lambda s: (s["lo"], -s["hi"]))
    owned, by_corr, open_, k = [], {}, [], 0
    for t, corr, name in sorted(trace.get("calls", [])):
        while k < len(spans) and spans[k]["lo"] <= t:
            open_.append(spans[k])
            k += 1
        open_ = [s for s in open_ if s["hi"] >= t]
        span = open_[-1] if open_ else None
        owned.append((name, span))
        by_corr[corr] = span
    ops = [(lo, hi, by_corr.get(corr))
           for lo, hi, corr in trace.get("ops", [])]
    return owned, ops


def enclosing(span, names, by_id: dict):
    """``span`` or the nearest of its parents named one of ``names``;
    None if neither is."""
    while span is not None:
        if span["name"] in names:
            return span
        span = by_id.get(span["parent"])
    return None


def busy_share_in(trace, name: str) -> float | None:
    """Per cent of the stretch from the start of the first device
    operation launched within a ``name`` span (or a span under one) to
    the end of the last, in which one of them ran."""
    by_id = {s["id"]: s for s in trace.get("spans", [])}
    _calls, ops = attribute(trace)
    mine = [(lo, hi) for lo, hi, s in ops
            if enclosing(s, (name,), by_id) is not None]
    if not mine:
        return None
    busy = sum(hi - lo for lo, hi in _union(mine))
    return 100.0 * busy / (max(hi for _lo, hi in mine)
                           - min(lo for lo, _hi in mine))


ENCODERS = ("encode_image", "encode_audio", "emotion")


def ttfc_parts(trace) -> list:
    """(encode, sample, decode and wire) milliseconds of each stream, by
    its root span (``generate_stream``, which ends at the first chunk's
    yield), in order: from the root's start t0 to E, the later of the
    last encoder span's end and its last device operation's; from E to
    S, the same milestone of the request's first ``sample.chunk``; from S
    to the root's end.  The three add up to the root's length."""
    spans = trace.get("spans", [])
    by_id = {s["id"]: s for s in spans}
    _calls, ops = attribute(trace)
    ends: dict = {}                 # span id -> end of its last operation
    for _lo, hi, s in ops:
        for name in ENCODERS + ("sample.chunk",):
            top = enclosing(s, (name,), by_id)
            if top is not None:
                ends[top["id"]] = max(ends.get(top["id"], hi), hi)
    out = []
    for root in sorted((s for s in spans if s["name"] == "generate_stream"),
                       key=lambda s: s["lo"]):
        mine = [s for s in spans if s["request"] == root["request"]]
        chunks = sorted((s for s in mine if s["name"] == "sample.chunk"),
                        key=lambda s: s["lo"])
        if not chunks:
            continue
        enc = [s for s in mine if s["name"] in ENCODERS]
        e = max([root["lo"]] + [max(s["hi"], ends.get(s["id"], s["hi"]))
                                for s in enc])
        first = chunks[0]
        m = max(e, first["hi"], ends.get(first["id"], first["hi"]))
        out.append(((e - root["lo"]) * 1e-3, (m - e) * 1e-3,
                    (root["hi"] - m) * 1e-3))
    return out
