"""Host launch calls (kernel and graph launches) made within the profiled
clip's ``sample.chunk`` spans (runtime/sampling.py), per chunk
(harness/program_spans.py)."""
import re

from harness.program_spans import attribute, enclosing, program_trace

LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel"
                    r"|GraphLaunch)")


def read(run):
    if run.device.type != "cuda":
        return None
    trace = program_trace(run)
    if trace is None:
        return None
    spans = trace["spans"]
    by_id = {s["id"]: s for s in spans}
    chunks = sum(s["name"] == "sample.chunk" for s in spans)
    calls, _ops = attribute(trace)
    n = sum(1 for name, s in calls if LAUNCH.match(name)
            and enclosing(s, ("sample.chunk",), by_id) is not None)
    if not chunks or not n:
        return None
    return n / chunks
