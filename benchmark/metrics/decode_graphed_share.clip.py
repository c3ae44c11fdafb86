"""Per cent of the profiled clip's ``decode.chunk`` spans
(runtime/decode.py) whose chunk was replayed from a CUDA graph, the
span's ``graphed`` count being 1 (harness/program_spans.py).  None where
the spans carry no ``graphed`` count: a program without decode graphs."""
from harness.program_spans import program_trace


def read(run):
    if run.device.type != "cuda":
        return None
    trace = program_trace(run)
    if trace is None:
        return None
    chunks = [s["attrs"] for s in trace["spans"]
              if s["name"] == "decode.chunk"]
    if not chunks or any("graphed" not in a for a in chunks):
        return None
    return 100.0 * sum(a["graphed"] for a in chunks) / len(chunks)
