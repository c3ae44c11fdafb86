"""Milliseconds of a profiled stream's time to its first chunk from its
encoders' milestone (``ttfc_encode_ms.stream``) to the same milestone of
its first ``sample.chunk`` span (runtime/sampling.py).  The median over
the profiled streams (harness/program_spans.py ``ttfc_parts``)."""
import statistics

from harness.program_spans import program_trace, ttfc_parts


def read(run):
    if run.device.type != "cuda":
        return None
    trace = program_trace(run)
    parts = [] if trace is None else ttfc_parts(trace)
    if not parts:
        return None
    return statistics.median(p[1] for p in parts)
