"""Per cent of the sampler's stretch of the profiled clip in which the
device ran its work: the union of the device intervals of the operations
launched within ``sample.chunk`` spans (runtime/sampling.py), over the
time from the first one's start to the last one's end
(harness/program_spans.py)."""
from harness.program_spans import busy_share_in, program_trace


def read(run):
    if run.device.type != "cuda":
        return None
    trace = program_trace(run)
    return None if trace is None else busy_share_in(trace, "sample.chunk")
