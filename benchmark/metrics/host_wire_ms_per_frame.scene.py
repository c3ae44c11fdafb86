"""Milliseconds of the ``decode_to_host`` spans a face frame: the decode
and its uint8 wire to host memory (runtime/pipeline.py)."""
from harness.readers import per_unit_ms


def read(run):
    faces = len(run.model["scene"]["boxes"])
    return per_unit_ms(run, ("decode_to_host",), lambda r: faces * r.frames)
