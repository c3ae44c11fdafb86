"""Host milliseconds in ``wire.pin`` spans (the pinned allocation and the
queued copy of runtime/decode.py ``_HostCopy``) per ``decode.chunk``
span, over the profiled streams (harness/program_spans.py)."""
from harness.program_spans import program_trace


def read(run):
    if run.device.type != "cuda":
        return None
    trace = program_trace(run)
    if trace is None:
        return None
    spans = trace["spans"]
    pin = [s["hi"] - s["lo"] for s in spans if s["name"] == "wire.pin"]
    chunks = sum(s["name"] == "decode.chunk" for s in spans)
    if not pin or not chunks:
        return None
    return 1e-3 * sum(pin) / chunks
