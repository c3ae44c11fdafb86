"""Arithmetic that several metric readers share."""
from __future__ import annotations

from collections import defaultdict


def rate(run) -> float | None:
    """Frames of every request started in the window over the seconds
    from the window's start to the end of the last of them."""
    done = [r for r in run.requests if not r.failed]
    if not done:
        return None
    return sum(r.frames for r in done) / (max(r.t1 for r in done)
                                          - run.window_t0)


def idle_share(run) -> float | None:
    """Per cent of the profiled stretch in which no operation ran on the
    device."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def span_seconds(run, *names) -> dict:
    """{request: seconds} of the spans named ``names``, summed."""
    out: dict = defaultdict(float)
    for name, index, t0, t1 in run.spans:
        if name in names:
            out[index] += t1 - t0
    return dict(out)


def per_unit_ms(run, names, unit) -> float | None:
    """Milliseconds of the spans ``names`` per ``unit(request)``, over the
    requests that have them."""
    secs = span_seconds(run, *names)
    reqs = [r for r in run.requests if r.index in secs]
    units = sum(unit(r) for r in reqs)
    if not units:
        return None
    return 1e3 * sum(secs[r.index] for r in reqs) / units
