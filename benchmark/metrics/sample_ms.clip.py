"""Milliseconds of the ``sample`` span a clip (runtime/sampling.py)."""
from harness.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, ("sample",), lambda r: 1)
