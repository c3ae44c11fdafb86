"""Milliseconds of a profiled stream's time to its first chunk before its
encoders are done (models/ encoders): from the root span's start to the
later of the last encoder span's end and the end of its last device
operation.  The median over the profiled streams; the three ``ttfc_*``
parts of a stream add up to its root span (harness/program_spans.py
``ttfc_parts``), printed beside the stream's own time to first chunk."""
import statistics
import sys

from harness.program_spans import program_trace, ttfc_parts


def read(run):
    if run.device.type != "cuda":
        return None
    trace = program_trace(run)
    parts = [] if trace is None else ttfc_parts(trace)
    if not parts:
        return None
    ttfc = [t for t in trace["ttfc_s"] if t is not None]
    for k, p in enumerate(parts):
        own = f"{1e3 * ttfc[k]!r}" if k < len(ttfc) else "?"
        print(f"[ttfc parts] ms: encode {p[0]!r} sample {p[1]!r} decode and "
              f"wire {p[2]!r}; sum {sum(p)!r}, the stream's own {own}",
              file=sys.stderr)
    return statistics.median(p[0] for p in parts)
