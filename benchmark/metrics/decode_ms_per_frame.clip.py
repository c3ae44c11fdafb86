"""Milliseconds of the ``decode`` span a frame (runtime/decode.py,
models/synthesis.py, ops/, kernels/)."""
from harness.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, ("decode",), lambda r: r.frames)
