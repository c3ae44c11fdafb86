"""Milliseconds of a profiled stream's time to its first chunk from its
first sampler chunk's milestone (``ttfc_sample_ms.stream``) to the first
chunk's yield: its decode, the host wire and the host's wait
(runtime/decode.py).  The median over the profiled streams
(harness/program_spans.py ``ttfc_parts``)."""
import statistics

from harness.program_spans import program_trace, ttfc_parts


def read(run):
    if run.device.type != "cuda":
        return None
    trace = program_trace(run)
    parts = [] if trace is None else ttfc_parts(trace)
    if not parts:
        return None
    return statistics.median(p[2] for p in parts)
